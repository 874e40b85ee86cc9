"""Slicing of the quorum engine's group batch (the multi-raft group batch
is the framework's data-parallel axis)."""

from ratis_tpu_torch.parallel.mesh import (GroupMesh, make_group_mesh,
                                           pad_to_mesh, shard_batch,
                                           shard_device_state,
                                           sharded_engine_step,
                                           sharded_ledger_pass,
                                           sharded_resident_fast_step,
                                           sharded_resident_fast_step_sliced,
                                           sharded_resident_step)

__all__ = ["GroupMesh", "make_group_mesh", "pad_to_mesh", "shard_batch",
           "shard_device_state", "sharded_engine_step", "sharded_ledger_pass",
           "sharded_resident_fast_step", "sharded_resident_fast_step_sliced",
           "sharded_resident_step"]
