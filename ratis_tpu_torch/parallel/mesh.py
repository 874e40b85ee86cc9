"""Mesh slicing of the quorum engine: the group batch in S slices.

The counterpart of ``ratis_tpu.parallel.mesh``.  There a mesh is a
``jax.sharding.Mesh`` of S devices, each holding one contiguous slice of
the ``[G, ...]`` consensus state; the production fast tick ships every
slice its own ``[7, S, E]`` event plane with SLICE-LOCAL row indices
(``engine_step_resident_fast_sliced``), and the quorum math is row-local,
so no step needs a collective.

Here a mesh is S slices of the group batch on ONE torch device: the layout
``jit(engine_step_resident_fast_sliced)`` computes on one device, and the
one the JAX package runs on its virtual-device CPU fleet.  Each state field
stays one contiguous ``[G, ...]`` tensor whose slice ``s`` is rows
``[s * G/S, (s + 1) * G/S)``; a mesh engine's fast tick is kernel K5 over
the S slices, its refresh tick K2 on the flat state with global rows (the
JAX refresh replicates its rows and events to every slice), its ledger
pass K4.  A mesh whose slices name more than one distinct card raises
``NotImplementedError``: spreading the slices over cards waits for a host
with several GPUs.

Kept from the JAX module: ``make_group_mesh``, ``pad_to_mesh``,
``shard_device_state`` and ``shard_batch`` (placement on the mesh's device,
with the divisibility check), and the ``sharded_*`` step makers, each of
which returns the port's kernel wrapper checked against the mesh:
``sharded_engine_step`` K6, ``sharded_resident_fast_step`` K1,
``sharded_resident_fast_step_sliced`` K5, ``sharded_resident_step`` K2,
``sharded_ledger_pass`` K4.  Left out: ``engine_shardings``,
``device_state_shardings`` and ``sliced_event_sharding``, which describe
XLA shardings; one device has none to describe.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ratis_tpu_torch.ops import ledger as ops_ledger
from ratis_tpu_torch.ops import quorum as q

def _card(device: torch.device) -> tuple:
    return device.type, device.index or 0


def same_card(a: "str | torch.device", b: "str | torch.device") -> bool:
    """Whether two torch devices are one card (``cuda`` is ``cuda:0``)."""
    return _card(torch.device(a)) == _card(torch.device(b))


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """``n_slices`` contiguous slices of the group batch on ``device``."""

    device: torch.device
    n_slices: int


def make_group_mesh(n_devices: Optional[int] = None,
                    device: "str | torch.device" = "cuda",
                    devices: Optional[Sequence] = None) -> GroupMesh:
    """A 1-D mesh of ``n_devices`` slices of the group axis on ``device``.
    ``devices`` names the device of each slice instead (the first
    ``n_devices`` of them when both are given); they must all be one card,
    else ``NotImplementedError``."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
        if len({_card(d) for d in devices}) > 1:
            raise NotImplementedError(
                f"a mesh over {sorted({str(d) for d in devices})}: "
                f"spreading the slices over several cards waits for a "
                f"host with several GPUs; slice one card instead")
        if not devices:
            raise ValueError("a mesh needs at least one slice")
        return GroupMesh(devices[0], len(devices))
    if n_devices is None or int(n_devices) < 1:
        raise ValueError(f"a mesh needs at least one slice, got {n_devices}")
    return GroupMesh(torch.device(device), int(n_devices))


def pad_to_mesh(groups: int, n_devices: int) -> int:
    """Round a group capacity up to the next multiple of the mesh size.
    Padded rows stay ROLE_UNUSED (masked invalid) and cost nothing; this
    replaces the old hard requirement that ``mesh-devices`` divide
    ``max-groups``."""
    n = max(1, int(n_devices))
    return -(-int(groups) // n) * n


def _check_rows(mesh: GroupMesh, t: torch.Tensor) -> None:
    """``t``'s group axis lies on the mesh's card and divides into its
    slices."""
    if not same_card(t.device, mesh.device):
        raise ValueError(f"tensor on {t.device}, mesh on {mesh.device}")
    g = t.shape[0]
    if g % mesh.n_slices:
        raise ValueError(f"group count {g} not divisible by mesh size "
                         f"{mesh.n_slices}")


def sharded_engine_step(mesh: GroupMesh):
    """The stateless fused tick (K6) over the mesh's group batch."""
    def step(*args):
        _check_rows(mesh, args[0])
        return q.engine_step(*args)
    return step


def sharded_resident_fast_step(mesh: GroupMesh):
    """The flat resident fast tick (K1) on the mesh's state: packed
    ``[7, E]`` events with global rows."""
    def step(state, ev_packed, meta):
        _check_rows(mesh, state.match_index)
        return q.engine_step_resident_fast(state, ev_packed, meta)
    return step


def sharded_resident_fast_step_sliced(mesh: GroupMesh):
    """The production mesh tick (K5): slice-routed ``[7, S, E]`` event
    planes, one per slice of the mesh, with slice-local rows."""
    def step(state, ev_packed, meta):
        _check_rows(mesh, state.match_index)
        if ev_packed.dim() != 3 or ev_packed.shape[1] != mesh.n_slices:
            raise ValueError(f"events of shape {tuple(ev_packed.shape)} on "
                             f"a mesh of {mesh.n_slices} slices")
        return q.engine_step_resident_fast_sliced(state, ev_packed, meta)
    return step


def sharded_resident_step(mesh: GroupMesh):
    """The dirty-row refresh tick (K2) on the mesh's state: refresh rows
    and events carry global rows, as the JAX refresh replicates them."""
    def step(state, *args):
        _check_rows(mesh, state.match_index)
        return q.engine_step_resident(state, *args)
    return step


def sharded_ledger_pass(mesh: GroupMesh, num_peers: int):
    """The telemetry tick's ledger pass (K4) over the mesh's group batch:
    its per-peer sections reduce over every slice, as the JAX pass's
    replicated output does."""
    def ledger(role, *args):
        _check_rows(mesh, role)
        return ops_ledger.ledger_pass(role, *args, num_peers=num_peers)
    return ledger


def shard_device_state(mesh: GroupMesh, state: q.DeviceState
                       ) -> q.DeviceState:
    """The DeviceState on the mesh's device (a field already there is
    kept, not copied)."""
    out = q.DeviceState(*(t.to(mesh.device) for t in state))
    _check_rows(mesh, out.match_index)
    return out


def shard_batch(mesh: GroupMesh, args: Sequence) -> tuple:
    """``engine_step``'s 17 arguments (numpy, the JAX order) as tensors on
    the mesh's device; the group axis must divide into the slices."""
    g = len(args[0])
    if g % mesh.n_slices:
        raise ValueError(f"group count {g} not divisible by mesh size "
                         f"{mesh.n_slices}")
    return q.engine_step_args_from_numpy(args, mesh.device)
