"""Snapshot transfer: leader-side chunking + follower-side installation.

Capability parity with the reference snapshot path:
- Leader: InstallSnapshotRequests chunk iterator bounded by chunk size
  (ratis-server/.../leader/InstallSnapshotRequests.java) and the
  notification mode for app-managed state transfer
  (GrpcLogAppender.notifyInstallSnapshot:805).
- Follower: SnapshotInstallationHandler + SnapshotManager
  (ratis-server/.../impl/SnapshotInstallationHandler.java:60,
  storage/SnapshotManager.java): MD5-verified chunks staged in tmp/,
  renamed into sm/, the StateMachine paused + reinitialized, the local log
  restarted above the snapshot.
"""

from __future__ import annotations

import asyncio
import hashlib
import pathlib
import time
from typing import AsyncIterator, Optional

from ratis_tpu_torch.protocol.exceptions import InstallSnapshotException
from ratis_tpu_torch.protocol.raftrpc import (FileChunk, InstallSnapshotReply,
                                        InstallSnapshotRequest,
                                        InstallSnapshotResult, RaftRpcHeader)
from ratis_tpu_torch.protocol.termindex import TermIndex
from ratis_tpu_torch.server.statemachine import SnapshotInfo


def file_md5(path: pathlib.Path) -> bytes:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.digest()


class SnapshotInstaller:
    """Follower-side receiver: stages chunks in tmp/, verifies MD5, commits
    into the SM storage directory."""

    def __init__(self, division):
        self.division = division
        self._staging: dict[str, object] = {}  # filename -> open file
        self._verified: set[str] = set()  # files completed+MD5-checked
        self._in_progress_index: int = -1

    @property
    def in_progress_index(self) -> int:
        return self._in_progress_index

    def _staging_dir(self) -> pathlib.Path:
        """Where this division stages an install: its log storage's tmp/,
        or, on the in-memory log, tmp/ inside its state machine's storage
        (one directory per group, as the reference's state machine
        storage tmp dir): never a directory that other groups' installs
        share, since staged names (``snapshot.<term>_<index>``) repeat
        across groups and a new install clears the directory's staged
        files."""
        div = self.division
        if div.storage is not None:
            return div.storage.tmp_dir
        sm_dir = div.state_machine.get_state_machine_storage().directory
        if sm_dir is None:
            raise InstallSnapshotException("state machine has no storage dir")
        return sm_dir / "tmp"

    def _tmp_path(self, filename: str) -> pathlib.Path:
        base = self._staging_dir()
        base.mkdir(parents=True, exist_ok=True)
        return base / (filename + ".install")

    async def receive(self, req: InstallSnapshotRequest) -> InstallSnapshotResult:
        div = self.division
        ti = req.snapshot_term_index
        if ti is None:
            return InstallSnapshotResult.CONF_MISMATCH
        current = div.state_machine.get_latest_snapshot()
        if current is not None and current.index >= ti.index:
            return InstallSnapshotResult.ALREADY_INSTALLED
        if self._in_progress_index != ti.index:
            # New install (possibly after an aborted one): drop stale staging
            # so unverified partials never reach the SM directory.
            self._abort_staging()
            self._in_progress_index = ti.index

        for chunk in req.chunks:
            tmp = self._tmp_path(chunk.filename)
            f = self._staging.get(chunk.filename)
            if f is None:
                f = open(tmp, "wb")
                self._staging[chunk.filename] = f
            if f.tell() != chunk.offset:
                f.seek(chunk.offset)
            f.write(chunk.data)
            if chunk.done:
                f.close()
                del self._staging[chunk.filename]
                if chunk.file_digest and file_md5(tmp) != chunk.file_digest:
                    tmp.unlink(missing_ok=True)
                    self._in_progress_index = -1
                    raise InstallSnapshotException(
                        f"MD5 mismatch for snapshot file {chunk.filename}")
                self._verified.add(chunk.filename)

        if not req.done:
            return InstallSnapshotResult.IN_PROGRESS
        await self._commit(ti)
        return InstallSnapshotResult.SUCCESS

    def _abort_staging(self) -> None:
        for f in self._staging.values():
            try:
                f.close()
            except Exception:
                pass
        self._staging.clear()
        self._verified.clear()
        base = self._staging_dir()
        if base.exists():
            for tmp in base.glob("*.install"):
                tmp.unlink(missing_ok=True)

    async def _commit(self, ti: TermIndex) -> None:
        div = self.division
        sm = div.state_machine
        storage = sm.get_state_machine_storage()
        sm_dir = storage.directory
        if sm_dir is None:
            raise InstallSnapshotException("state machine has no storage dir")
        await sm.pause()
        try:
            base = self._staging_dir()
            # Promote ONLY files completed and MD5-verified in this install;
            # leftovers from aborted installs stay out of sm/.
            for name in self._verified:
                tmp = base / (name + ".install")
                if tmp.exists():
                    tmp.replace(sm_dir / name)
            await sm.reinitialize()
        finally:
            self._verified.clear()
            self._in_progress_index = -1
        # Local log restarts just above the installed snapshot
        # (reference SnapshotInstallationHandler pause/reload + log purge).
        div.state.log.set_snapshot_boundary(ti)
        div.set_applied_index(ti.index)
        await sm.notify_snapshot_installed(
            SnapshotInfo(ti), div.member_id.peer_id)


class SnapshotSender:
    """Leader-side driver: streams chunk batches to one follower, or sends
    the notification when file transfer is disabled."""

    def __init__(self, division, chunk_size: int = 16 << 20,
                 install_enabled: bool = True):
        self.division = division
        self.chunk_size = chunk_size
        self.install_enabled = install_enabled

    async def send_to(self, follower) -> bool:
        """Returns True if the follower was advanced (nextIndex bumped)."""
        div = self.division
        snapshot = div.state_machine.get_latest_snapshot()
        header = RaftRpcHeader(div.member_id.peer_id, follower.peer_id,
                               div.group_id)

        if not self.install_enabled or snapshot is None:
            first = div.state.log.get_term_index(div.state.log.start_index) \
                or TermIndex(div.state.current_term, div.state.log.start_index)
            req = InstallSnapshotRequest(
                header, div.state.current_term,
                notification_first_available=first,
                last_included=snapshot.term_index if snapshot else None)
            reply = await div.server.send_server_rpc(follower.peer_id, req)
            if reply.result in (InstallSnapshotResult.SUCCESS,
                                InstallSnapshotResult.ALREADY_INSTALLED,
                                InstallSnapshotResult.SNAPSHOT_INSTALLED) \
                    and reply.snapshot_index >= 0:
                follower.next_index = max(follower.next_index,
                                          reply.snapshot_index + 1)
                return True
            return False

        # Stream chunk batches straight from disk — never materialize the
        # whole snapshot in memory (one read per request, like the reference
        # FileChunkReader).
        files = [pathlib.Path(fi.path) for fi in snapshot.files]
        digests = {p.name: (fi.digest or await asyncio.to_thread(file_md5, p))
                   for p, fi in zip(files, snapshot.files)}
        request_index = 0
        for fidx, path in enumerate(files):
            total = path.stat().st_size
            offset = 0
            chunk_idx = 0
            with open(path, "rb") as f:
                while True:
                    data = await asyncio.to_thread(f.read, self.chunk_size)
                    file_done = offset + len(data) >= total
                    last_file = fidx == len(files) - 1
                    chunk = FileChunk(
                        filename=path.name, total_size=total,
                        file_digest=digests[path.name],
                        chunk_index=chunk_idx, offset=offset, data=data,
                        done=file_done)
                    req = InstallSnapshotRequest(
                        header, div.state.current_term,
                        request_id=str(div.member_id),
                        request_index=request_index,
                        snapshot_term_index=snapshot.term_index,
                        chunks=(chunk,), total_size=total,
                        done=file_done and last_file)
                    request_index += 1
                    reply = await div.server.send_server_rpc(
                        follower.peer_id, req)
                    # A chunk reply is proof of life: refresh the response
                    # clock so slowness detection doesn't fire mid-install.
                    follower.last_rpc_response_s = time.monotonic()
                    if reply.result == InstallSnapshotResult.ALREADY_INSTALLED:
                        follower.next_index = max(follower.next_index,
                                                  snapshot.index + 1)
                        return True
                    if reply.result not in (InstallSnapshotResult.SUCCESS,
                                            InstallSnapshotResult.IN_PROGRESS):
                        return False
                    offset += len(data)
                    chunk_idx += 1
                    if file_done:
                        break
        follower.next_index = max(follower.next_index, snapshot.index + 1)
        follower.update_match(snapshot.index)
        return True
