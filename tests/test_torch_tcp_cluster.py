"""The slice over real TCP sockets: the JAX package's cluster and the
port's, 3 servers x 32 groups each on ``127.0.0.1`` ports the kernel
picks when the servers bind (``transport/tcp.py``, a verbatim copy in the
port), through the same two runs as ``test_torch_cluster.py``; the
port's groups must name the ports its servers listen on.

Both must acknowledge every write, read counter == writes back from every
replica, show batched dispatches, fast and refresh ticks, batched vote
tallies and ledger samples; their counters must be equal.  The harness's
properties must be the JAX bench's ``bench_properties(batched=True)`` key
for key, plus the port's engine device.
"""

import pytest

from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.tools.cluster import cluster_properties

from tests.test_torch_cluster import run_both_and_compare


def test_tcp_cluster_slice_matches_jax(monkeypatch):
    runs = run_both_and_compare(monkeypatch, "tcp")
    assert set(runs["torch"]["transports"]) == {"TcpServerTransport"}
    addresses = runs["torch"]["addresses"]
    assert addresses == runs["torch"]["listening"] and len(addresses) == 3
    assert all(a.startswith("127.0.0.1:") and int(a.rsplit(":", 1)[1]) > 0
               for a in addresses)


# channel counts below and at each timeout tier (2048, 4096, 16384, 32768)
@pytest.mark.parametrize("groups", [32, 1024, 2048, 8192, 16384])
@pytest.mark.parametrize("transport", ["sim", "tcp"])
def test_properties_are_the_jax_bench_properties(transport, groups):
    port = dict(cluster_properties(groups, 3, "cuda", transport).items())
    jax = dict(bench_properties(True, groups, num_servers=3,
                                transport=transport).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    if transport == "tcp":
        assert port["raft.tpu.tcp.flush-bytes"] == "128KB"
        assert port["raft.tpu.tcp.flush-micros"] == "100"
        assert port["raft.tpu.gc.discipline"] == "true"
        assert port["raft.tpu.gc.refreeze-interval"] == "15s"


def test_unknown_transport_is_refused():
    with pytest.raises(ValueError, match="transport"):
        cluster_properties(4, 3, "cpu", "grpc")
