"""FileStore: a replicated file service exercising the DataStream path.

Capability parity with the reference filestore example
(ratis-examples/src/main/java/org/apache/ratis/examples/filestore/
FileStoreStateMachine.java:48 + FileStore.java): small files ride the raft
log as WRITE transactions; large files stream peer-to-peer over the
DataStream path (``stream``:196 opens a channel into a temp file,
``link``:210 renames it into place when the raft entry commits).  Queries
read file bytes / list the store.

Commands (msgpack dicts in the Message body):
  write  {op, path, data}     — file content through the log
  stream {op, path, size}     — DataStream header; bytes arrive out of band
  delete {op, path}
  read   {op, path} (query)   — file bytes
  list   {op} (query)         — sorted file names
"""

from __future__ import annotations

import asyncio
import os
import pathlib
import tempfile
from typing import Dict, Optional

import msgpack

from ratis_tpu_torch.protocol.message import Message
from ratis_tpu_torch.server.statemachine import (BaseStateMachine, DataChannel,
                                           DataStream, TransactionContext)


def _safe_relpath(path: str) -> pathlib.PurePosixPath:
    p = pathlib.PurePosixPath(path)
    if p.is_absolute() or ".." in p.parts or not p.parts:
        raise ValueError(f"unsafe path {path!r}")
    return p


class FileChunkChannel(DataChannel):
    """Streams into ``<root>/.tmp/<stream>``; linked (renamed) at apply."""

    def __init__(self, tmp_path: pathlib.Path) -> None:
        self.tmp_path = tmp_path
        self._file = open(tmp_path, "wb")

    async def write(self, data: bytes) -> int:
        return await asyncio.to_thread(self._file.write, data)

    async def force(self, metadata: bool = False) -> None:
        def _sync():
            self._file.flush()
            os.fsync(self._file.fileno())
        await asyncio.to_thread(_sync)

    async def close(self) -> None:
        if not self._file.closed:
            await asyncio.to_thread(self._file.close)


class FileStoreDataStream(DataStream):
    def __init__(self, channel: FileChunkChannel, request,
                 target: pathlib.PurePosixPath) -> None:
        super().__init__(channel, request)
        self.target = target

    async def cleanup(self) -> None:
        await self.channel.close()
        self.channel.tmp_path.unlink(missing_ok=True)


class FileStoreStateMachine(BaseStateMachine):
    def __init__(self, root: Optional[str] = None) -> None:
        super().__init__()
        self._explicit_root = root
        self._root: Optional[pathlib.Path] = None
        self._tmp_holder: Optional[tempfile.TemporaryDirectory] = None
        self.files: Dict[str, int] = {}  # path -> size (committed metadata)
        self._stream_seq = 0

    # ------------------------------------------------------------- layout

    @property
    def root(self) -> pathlib.Path:
        if self._root is None:
            if self._explicit_root is not None:
                self._root = pathlib.Path(self._explicit_root)
            elif self._storage.directory is not None:
                self._root = self._storage.directory / "files"
            else:  # volatile group: keep files in a temp dir for our lifetime
                self._tmp_holder = tempfile.TemporaryDirectory(
                    prefix="filestore-")
                self._root = pathlib.Path(self._tmp_holder.name)
            (self._root / ".tmp").mkdir(parents=True, exist_ok=True)
        return self._root

    def resolve(self, path: str) -> pathlib.Path:
        return self.root / _safe_relpath(path)

    async def close(self) -> None:
        if self._tmp_holder is not None:
            self._tmp_holder.cleanup()
        await super().close()

    # ----------------------------------------------------------- pipeline

    async def start_transaction(self, request) -> TransactionContext:
        trx = TransactionContext(client_request=request,
                                 log_data=request.message.content)
        try:
            cmd = msgpack.unpackb(request.message.content, raw=False)
            op = cmd["op"]
            if op not in ("write", "stream", "delete"):
                raise ValueError(f"not a transaction op: {op!r}")
            _safe_relpath(cmd["path"])
        except Exception as e:
            trx.exception = e
        return trx

    async def apply_transaction(self, trx: TransactionContext) -> Message:
        e = trx.log_entry
        payload = (e.smlog.log_data if e is not None and e.smlog is not None
                   else (trx.log_data or b""))
        cmd = msgpack.unpackb(payload, raw=False)
        op, path = cmd["op"], cmd.get("path", "")
        reply: dict
        if op == "write":
            target = self.resolve(path)
            target.parent.mkdir(parents=True, exist_ok=True)
            await asyncio.to_thread(self._atomic_write, target, cmd["data"])
            self.files[path] = len(cmd["data"])
            reply = {"ok": True, "size": len(cmd["data"])}
        elif op == "stream":
            # bytes were linked into place just before apply (data_link);
            # a peer outside the routing table simply has no local copy
            target = self.resolve(path)
            if target.exists():
                size = target.stat().st_size
                self.files[path] = size
                reply = {"ok": True, "size": size}
            else:
                reply = {"ok": False, "error": "data not streamed here"}
        elif op == "delete":
            target = self.resolve(path)
            await asyncio.to_thread(target.unlink, True)
            self.files.pop(path, None)
            reply = {"ok": True}
        else:
            reply = {"ok": False, "error": f"unknown op {op!r}"}
        if e is not None:
            self.update_last_applied_term_index(e.term, e.index)
        return Message(msgpack.packb(reply, use_bin_type=True))

    @staticmethod
    def _atomic_write(target: pathlib.Path, data: bytes) -> None:
        tmp = target.with_name(target.name + ".part")
        tmp.write_bytes(data)
        tmp.replace(target)

    # -------------------------------------------------------------- query

    async def query(self, request: Message) -> Message:
        cmd = msgpack.unpackb(request.content, raw=False)
        op = cmd["op"]
        if op == "read":
            target = self.resolve(cmd["path"])
            data = await asyncio.to_thread(target.read_bytes)
            return Message(msgpack.packb({"ok": True, "data": data},
                                         use_bin_type=True))
        if op == "list":
            return Message(msgpack.packb(
                {"ok": True, "files": sorted(self.files)},
                use_bin_type=True))
        raise ValueError(f"unknown query {op!r}")

    async def query_stale(self, request: Message, min_index: int) -> Message:
        return await self.query(request)

    # ----------------------------------------------------------- DataApi

    async def data_stream(self, request) -> DataStream:
        cmd = msgpack.unpackb(request.message.content, raw=False)
        if cmd.get("op") != "stream":
            raise ValueError("datastream header must be a stream op")
        target = _safe_relpath(cmd["path"])
        self._stream_seq += 1
        tmp = self.root / ".tmp" / \
            f"stream_{request.type.stream_id}_{self._stream_seq}"
        return FileStoreDataStream(FileChunkChannel(tmp), request, target)

    async def data_link(self, stream: Optional[DataStream], entry) -> None:
        if stream is None:
            return
        await stream.channel.close()
        target = self.root / stream.target
        target.parent.mkdir(parents=True, exist_ok=True)
        await asyncio.to_thread(os.replace, stream.channel.tmp_path, target)
