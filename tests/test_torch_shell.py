"""The admin shell and the small tools, the port against the JAX package.

``shell/`` (``__init__``, ``__main__``, ``cli``), ``tools/parse_log.py``
and ``tools/loadgen.py`` are verbatim copies; ``tools/membership_console.py``
is a changed copy whose servers' engines take a device (default ``cuda``).
Here, as ``tests/test_shell_tools.py`` and ``tests/test_admin_features.py``
drive the JAX package:

- ``parse_peers``; ``group list`` / ``info`` and ``election transfer`` /
  ``pause`` / ``resume`` against a port cluster over gRPC (one group),
  and ``python -m ratis_tpu_torch.shell group info`` as a subprocess;
- ``parse_log`` on the segment files of a port cluster's durable log:
  its output byte-equal to the JAX package's ``parse_log`` on the same
  files, and the entries it counts equal to the division's log;
  ``local raftMetaConf`` rewriting that cluster's ``raft-meta.conf``;
- the HTTP commands ``health``, ``lag`` and ``top`` as subprocesses
  against a 3 x 4 port cluster over TCP with telemetry and the HTTP
  endpoint on: ``lag`` and ``top`` exit 0 and list every server, the JAX
  package's shell gives the same rows and exit codes on the same servers;
- ``loadgen --log-path`` against a port FileStore cluster over gRPC, its
  files then on every replica;
- ``membership_console.run_script`` with ``device="cpu"``, and without a
  device on a machine without CUDA it raises (the console's engines run
  on the card unless asked).

The gRPC cases skip where ``grpcio`` is missing (the card host).
"""

import asyncio
import os
import pathlib
import subprocess
import sys

import pytest

from ratis_tpu_torch.shell.cli import build_parser, parse_peers
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT), "PATH": os.environ.get("PATH", "/usr/bin"),
       "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp")}


def _parse(argv):
    return build_parser().parse_args(argv)


def _spec(group) -> str:
    return ",".join(f"{p.id}={p.address}" for p in group.peers)


async def _run(*argv) -> tuple[int, str, str]:
    """A command of this repo as a subprocess, the loop serving meanwhile."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *argv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=ENV, cwd=ROOT)
    out, err = await asyncio.wait_for(proc.communicate(), 120)
    return proc.returncode, out.decode(), err.decode()


def test_parse_peers_forms():
    peers = parse_peers("s0=h1:1,s1=h2:2")
    assert [str(p.id) for p in peers] == ["s0", "s1"]
    assert peers[0].address == "h1:1"
    bare = parse_peers("10.0.0.1:9000")
    assert bare[0].address == "10.0.0.1:9000"
    assert str(bare[0].id) == "10_0_0_1_9000"
    with pytest.raises(ValueError):
        parse_peers("  ,  ")


def _grpc_cluster(groups: int = 1, sm: str = "counter") -> Cluster:
    pytest.importorskip("grpc")
    return Cluster(groups, device="cpu", transport="grpc", sm=sm)


def test_shell_group_and_election_commands():
    async def main():
        cluster = _grpc_cluster()
        try:
            await cluster.start(timeout=60)
            g = cluster.groups[0]
            spec, gid = _spec(g), str(g.group_id.uuid)
            for argv in (["group", "list", "-peers", spec],
                         ["group", "info", "-peers", spec, "-groupid", gid],
                         ["group", "info", "-peers", spec]):
                args = _parse(argv)
                assert await args.func(args) == 0, argv
            leader = cluster.leader_of(g)
            follower = next(s for s in cluster.servers if s is not leader)
            args = _parse(["election", "transfer", "-peers", spec,
                           "-peerId", str(follower.peer_id), "-groupid",
                           gid])
            assert await args.func(args) == 0
            await cluster.wait_leaders([g], 30)
            assert cluster.leader_of(g) is follower
            other = next(s for s in cluster.servers if s is not follower)
            for cmd in ("pause", "resume"):
                args = _parse(["election", cmd, "-peers", spec, "-peerId",
                               str(other.peer_id), "-groupid", gid])
                assert await args.func(args) == 0, cmd
            rc, out, err = await _run("ratis_tpu_torch.shell", "group",
                                      "info", "-peers", spec)
            assert rc == 0, err
            assert "leader:" in out and "commit index:" in out
        finally:
            await cluster.close()

    asyncio.run(main())


async def _durable_cluster(tmp: pathlib.Path, writes: int) -> Cluster:
    cluster = Cluster(1, device="cpu", transport="tcp",
                      properties=cluster_properties(1, 3, "cpu", "tcp",
                                                    storage_dir=str(tmp)))
    await cluster.start(timeout=60)
    await cluster.write_all(writes)
    return cluster


def test_parse_log_matches_jax_on_the_same_segments(tmp_path):
    from ratis_tpu_torch.tools.parse_log import dump_segment
    writes = 5

    async def main():
        cluster = await _durable_cluster(tmp_path, writes)
        try:
            g = cluster.groups[0]
            logs = {str(s.peer_id): s.divisions[g.group_id].state.log
                    for s in cluster.servers}
            # the log starts at index 0 (no snapshot was taken)
            return {p: log.get_last_entry_term_index().index + 1
                    for p, log in logs.items()}
        finally:
            await cluster.close()

    spans = asyncio.run(main())
    segments = sorted(tmp_path.rglob("log_*"))
    assert segments
    counted = {}
    for seg in segments:
        port = subprocess.run(
            [sys.executable, "-m", "ratis_tpu_torch.tools.parse_log",
             str(seg)], capture_output=True, env=ENV, cwd=ROOT, timeout=120)
        jax = subprocess.run(
            [sys.executable, "-m", "ratis_tpu.tools.parse_log", str(seg)],
            capture_output=True, env=ENV, cwd=ROOT, timeout=120)
        assert port.returncode == jax.returncode == 0, port.stderr
        assert port.stdout == jax.stdout, seg
        peer = seg.relative_to(tmp_path).parts[0]
        lines = []
        counted[peer] = counted.get(peer, 0) + dump_segment(
            str(seg), out=lines.append)
        text = "\n".join(lines)
        assert "STATE_MACHINE" in text and "CONFIGURATION" in text
    # every replica's segments hold its whole log: the bring-up's
    # configuration entry, the leader's first entry, the writes
    assert set(counted) == set(spans)
    for peer, entries in spans.items():
        assert counted[peer] == entries >= writes, peer


def test_local_raft_meta_conf(tmp_path):
    async def main():
        cluster = await _durable_cluster(tmp_path, 1)
        await cluster.close()

    asyncio.run(main())
    conf_files = list(tmp_path.rglob("raft-meta.conf"))
    assert conf_files
    current_dir = conf_files[0].parent
    args = _parse(["local", "raftMetaConf", "-path", str(current_dir),
                   "-peers", "n0=h1:1,n1=h2:2,n2=h3:3"])
    assert args.func(args) == 0
    from ratis_tpu_torch.protocol.logentry import LogEntry
    rewritten = LogEntry.from_bytes(conf_files[0].read_bytes())
    assert sorted(str(p.id) for p in rewritten.conf.peers) == \
        ["n0", "n1", "n2"]
    assert (current_dir / "raft-meta.conf.bak").exists()


def test_http_commands_against_a_port_cluster():
    props = cluster_properties(4, 3, "cpu", "tcp")
    props.set("raft.tpu.telemetry.enabled", "true")
    props.set("raft.tpu.telemetry.interval", "250ms")
    props.set("raft.tpu.metrics.http-port", "0")

    async def main():
        cluster = Cluster(4, device="cpu", transport="tcp",
                          properties=props)
        try:
            await cluster.start(timeout=60)
            await cluster.write_all(2)
            await asyncio.sleep(1.2)   # a ledger sample on every server
            endpoints = ",".join(cluster.http_addresses())
            out = {}
            for pkg in ("ratis_tpu_torch", "ratis_tpu"):
                shell = f"{pkg}.shell"
                out[pkg] = {
                    "lag": await _run(shell, "lag", "-endpoints",
                                      endpoints),
                    "health": await _run(shell, "health", "-endpoints",
                                         endpoints),
                    "top": await _run(shell, "top", "-endpoints", endpoints,
                                      "-iterations", "1")}
            return out, [str(s.peer_id) for s in cluster.servers]
        finally:
            await cluster.close()

    out, peers = asyncio.run(main())
    port, jax = out["ratis_tpu_torch"], out["ratis_tpu"]
    for name in ("lag", "top"):
        assert port[name][0] == jax[name][0], (name, port[name][2])

    def rows(text):
        return sorted(line.split()[0] for line in text.splitlines()
                      if line.split() and line.split()[0] in peers)
    rc, text, err = port["lag"]
    assert rc == 0, err
    assert rows(text) == rows(jax["lag"][1]) == sorted(peers)
    rc, text, err = port["top"]
    assert rc == 0, err
    assert rows(text) == sorted(peers)
    rc, text, err = port["health"]
    assert rc in (0, 1), err
    assert text.startswith("cluster: 3/3 server(s) healthy")


def test_loadgen_log_path_against_a_filestore_cluster():
    async def main():
        cluster = _grpc_cluster(sm="filestore")
        try:
            await cluster.start(timeout=60)
            g = cluster.groups[0]
            rc, out, err = await _run(
                "ratis_tpu_torch.tools.loadgen", "-peers", _spec(g),
                "-numFiles", "3", "-size", "4096", "-numClients", "2",
                "--log-path")
            files = {}
            for s in cluster.servers:
                sm = s.divisions[g.group_id].state_machine
                deadline = asyncio.get_running_loop().time() + 30
                while len(sm.files) < 6:
                    assert asyncio.get_running_loop().time() < deadline
                    await asyncio.sleep(0.05)
                files[str(s.peer_id)] = dict(sm.files)
            return rc, out, err, files
        finally:
            await cluster.close()

    rc, out, err, files = asyncio.run(main())
    assert rc == 0, err
    assert "files: 6/6 ok, 0 errors" in out
    want = {f"loadgen/c{c}/f{i}.bin": 4096 for c in range(2)
            for i in range(3)}
    assert list(files.values()) == [want] * 3


def test_membership_console_script_on_cpu():
    from tests.minicluster import free_port
    from ratis_tpu_torch.tools.membership_console import run_script
    ports = [free_port() for _ in range(4)]
    initial, extra = ports[:3], ports[3]
    out = asyncio.run(run_script(initial, [
        "show", "incr", "incr", "query", f"add {extra}", "show", "incr",
        f"remove {initial[0]}", "show", "query"], device="cpu"))
    assert "cluster peers:" in out[0] and out[0].count("p") >= 3
    assert out[3] == "counter = 2"
    assert str(extra) in out[4]
    assert f"p{extra}" in out[5]
    assert out[6] == "counter = 3"
    assert f"p{initial[0]}" not in out[8]
    assert out[9] == "counter = 3"


def test_membership_console_runs_on_the_card_unless_asked():
    import torch
    from ratis_tpu_torch.tools.membership_console import MembershipCluster
    cluster = MembershipCluster()
    assert cluster.properties.get("raft.torch.engine.device") == "cuda"
    if torch.cuda.is_available():
        return
    from tests.minicluster import free_port
    from ratis_tpu_torch.tools.membership_console import run_script
    with pytest.raises(RuntimeError):
        asyncio.run(run_script([free_port()], ["show"]))
