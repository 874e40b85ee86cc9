"""RaftStorage: on-disk layout, lock, metadata, and conf files per division.

Capability parity with the reference storage layer
(ratis-server/.../storage/RaftStorageImpl.java, RaftStorageDirectoryImpl.java:40-98):

    <root>/<groupId-uuid>/
        in_use.lock              exclusive-use marker
        current/
            raft-meta            (term, votedFor) — atomic tmp+rename
            raft-meta.conf       latest committed RaftConfiguration entry
            log_<s>-<e>          closed log segments
            log_inprogress_<s>   the open segment
        sm/                      StateMachine snapshots
        tmp/                     staging (snapshot install, atomic writes)

Atomic writes follow the reference AtomicFileOutputStream (tmp + rename);
metadata is msgpack instead of the reference's java Properties text.
"""

from __future__ import annotations

import asyncio
import os
import pathlib
from typing import Optional

import msgpack

from ratis_tpu_torch.protocol.exceptions import AlreadyClosedException, RaftException
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.logentry import LogEntry
from ratis_tpu_torch.server.state import MetadataIO


_TMP_IDS = __import__("itertools").count(1)


def atomic_write(path: pathlib.Path, data: bytes) -> None:
    """tmp + fsync + rename (reference AtomicFileOutputStream).  The tmp
    name is unique per call: two concurrent writers of the SAME target
    (mass step-downs persisting raft-meta from racing to_thread workers
    — found by the chaos campaign's leader-crash scenario at 1024
    groups) must degrade to last-rename-wins, not to one of them
    renaming the other's half-written (or already-consumed) tmp away."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}.{next(_TMP_IDS)}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RaftStorageDirectory:
    META_FILE = "raft-meta"
    CONF_FILE = "raft-meta.conf"
    LOCK_FILE = "in_use.lock"

    def __init__(self, root: "str | pathlib.Path", group_id: RaftGroupId):
        self.root = pathlib.Path(root) / str(group_id.uuid)
        self.current = self.root / "current"
        self.sm_dir = self.root / "sm"
        self.tmp_dir = self.root / "tmp"
        self.group_id = group_id
        self._locked = False

    def format(self) -> None:
        for d in (self.current, self.sm_dir, self.tmp_dir):
            d.mkdir(parents=True, exist_ok=True)

    def lock(self) -> None:
        """Exclusive-use marker (reference in_use.lock).  Single-process
        protection: O_EXCL create; stale locks from crashed processes are
        reclaimed when the recorded pid is dead."""
        lock = self.root / self.LOCK_FILE
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
        except FileExistsError:
            try:
                pid = int(lock.read_text() or "0")
            except ValueError:
                pid = 0
            alive = False
            if pid > 0:
                if pid == os.getpid():
                    alive = True  # another division in THIS process holds it
                else:
                    try:
                        os.kill(pid, 0)
                        alive = True
                    except OSError:
                        alive = False
            if alive:
                raise RaftException(
                    f"storage {self.root} is locked by live pid {pid}")
            lock.write_text(str(os.getpid()))
        self._locked = True

    def unlock(self) -> None:
        if self._locked:
            (self.root / self.LOCK_FILE).unlink(missing_ok=True)
            self._locked = False

    # -- raft-meta ------------------------------------------------------------

    def persist_metadata(self, term: int, voted_for: Optional[RaftPeerId]) -> None:
        data = msgpack.packb({"t": term,
                              "v": None if voted_for is None else voted_for.id})
        atomic_write(self.current / self.META_FILE, data)

    def load_metadata(self) -> tuple[int, Optional[RaftPeerId]]:
        path = self.current / self.META_FILE
        if not path.exists():
            return 0, None
        d = msgpack.unpackb(path.read_bytes(), raw=False)
        v = d.get("v")
        return d.get("t", 0), None if v is None else RaftPeerId.value_of(v)

    # -- raft-meta.conf -------------------------------------------------------

    def persist_conf_entry(self, entry: LogEntry) -> None:
        atomic_write(self.current / self.CONF_FILE, entry.to_bytes())

    def load_conf_entry(self) -> Optional[LogEntry]:
        path = self.current / self.CONF_FILE
        if not path.exists():
            return None
        return LogEntry.from_bytes(path.read_bytes())

    def exists(self) -> bool:
        return self.current.exists()


class FileMetadataIO(MetadataIO):
    """ServerState's (term, votedFor) persistence over RaftStorageDirectory.
    The blocking fsync runs in a thread so the event loop never stalls.

    Persists SERIALIZE per division and never regress the on-disk term:
    a vote handler and an append handler can both drive a term update in
    the same burst, and with unserialized to_thread workers the OLDER
    term could land last on disk — a durable term regression that lets a
    restarted node double-vote (found by the chaos campaign's election
    storms)."""

    def __init__(self, directory: RaftStorageDirectory):
        self.directory = directory
        self._lock = asyncio.Lock()
        self._last_term = -1

    async def persist(self, term: int, voted_for: Optional[RaftPeerId]) -> None:
        async with self._lock:
            if term < self._last_term:
                return  # stale writer lost the race; newer term is on disk
            self._last_term = term
            await asyncio.to_thread(self.directory.persist_metadata, term,
                                    voted_for)

    async def load(self) -> tuple[int, Optional[RaftPeerId]]:
        return self.directory.load_metadata()


def scan_group_dirs(root: "str | pathlib.Path") -> list[RaftGroupId]:
    """Boot-time discovery of hosted groups (RaftServerProxy.initGroups:257)."""
    rootp = pathlib.Path(root)
    out = []
    if not rootp.exists():
        return out
    for child in rootp.iterdir():
        if not child.is_dir():
            continue
        try:
            gid = RaftGroupId.value_of(child.name)
        except ValueError:
            continue
        if (child / "current").exists():
            out.append(gid)
    return out
