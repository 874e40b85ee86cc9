"""TCP transport: raw-socket envelope RPC (the Netty-analog backend).

Capability parity with the reference Netty transport
(ratis-netty/src/main/java/org/apache/ratis/netty/server/NettyRpcService.java
+ NettyRpcProxy + Netty.proto:31-48): a single length-prefixed
request/reply envelope union over all RPCs — server-to-server consensus
traffic and client requests share one listening port, exactly like the
reference's RaftNettyServerRequestProto union.  asyncio streams take the
place of Netty's event loop; connections are cached per destination and
multiplex concurrent calls by a request sequence number.

Frame: u32 length | u64 call_seq | u8 kind | msgpack body.
kind: 1=server-rpc 2=client-request 3=reply 4=error-reply.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
from typing import Callable, Dict, Optional

from ratis_tpu_torch.metrics.hops import hop
from ratis_tpu_torch.protocol.exceptions import (RaftException, TimeoutIOException,
                                           exception_from_wire,
                                           exception_to_wire)
from ratis_tpu_torch.protocol.ids import RaftPeerId
from ratis_tpu_torch.protocol.raftrpc import decode_rpc, encode_rpc
from ratis_tpu_torch.protocol.requests import (DEFERRED_REPLY, RaftClientReply,
                                         RaftClientRequest,
                                         attach_reply_sink)
from ratis_tpu_torch.trace.tracer import (INGRESS_NS, STAGE_DECODE, STAGE_ENCODE,
                                    STAGE_RESPOND, STAGE_WIRE, TRACER)
from ratis_tpu_torch.transport.base import (ClientRequestHandler, ClientTransport,
                                      ServerRpcHandler, ServerTransport,
                                      TransportFactory)
from ratis_tpu_torch.transport.coalesce import WriteCoalescer

LOG = logging.getLogger(__name__)

KIND_SERVER_RPC = 1
KIND_CLIENT_REQUEST = 2
KIND_REPLY = 3
KIND_ERROR = 4

_FRAME = struct.Struct(">IQB")
MAX_FRAME = 256 << 20


def _encode_frame(call_seq: int, kind: int, body: bytes) -> bytes:
    return _FRAME.pack(9 + len(body), call_seq, kind) + body


class _StreamFrameCoalescer(WriteCoalescer):
    """WriteCoalescer over an asyncio StreamWriter: the batch goes out as
    ONE buffered write (frames are already length-prefixed, so joining is
    byte-identical to writing them one by one) followed by ONE drain."""

    def __init__(self, writer: asyncio.StreamWriter,
                 flush_bytes: int = 0, flush_micros: int = 0):
        super().__init__(flush_bytes=flush_bytes, flush_micros=flush_micros)
        self._writer = writer

    async def _flush_batch(self, frames: list) -> None:
        w = self._writer
        w.write(frames[0] if len(frames) == 1 else b"".join(frames))
        await w.drain()


def _flush_conf(properties) -> tuple[int, int]:
    """(flush_bytes, flush_micros) for the TCP transport; (0, 0) — the
    per-frame path — when unconfigured."""
    if properties is None:
        return 0, 0
    from ratis_tpu_torch.conf.keys import WireConfigKeys
    return (WireConfigKeys.Tcp.flush_bytes(properties),
            WireConfigKeys.Tcp.flush_micros(properties))


def _defer_conf(properties) -> bool:
    """Whether client requests get a deferred-reply sink attached (the
    commit fan-out collapse, raft.tpu.replication.sweep/reply-fanout)."""
    if properties is None:
        return False
    from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
    K = RaftServerConfigKeys.Replication
    return K.sweep(properties) and K.reply_fanout(properties)


class _DeferredReplyFanout:
    """Per-connection deferred-reply batcher: the division's waterline
    fan-out calls :meth:`submit` synchronously (possibly from a shard
    loop); replies queue here and ONE armed callback per burst drains them
    into the connection's write coalescer — one scheduled hop per batch
    per connection, replacing the per-request handler-resume + send-wait
    chain the traced decomposition measured as ``server.reply`` /
    ``server.respond``."""

    __slots__ = ("_conn_out", "_loop", "_q", "_lock", "_armed")

    def __init__(self, conn_out: "_StreamFrameCoalescer",
                 loop: asyncio.AbstractEventLoop) -> None:
        import collections
        import threading
        self._conn_out = conn_out
        self._loop = loop
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._armed = False

    def sink_for(self, call_seq: int, trace_id: int = 0):
        def sink(reply: RaftClientReply) -> None:
            self.submit(call_seq, reply, trace_id)
        return sink

    def submit(self, call_seq: int, reply: RaftClientReply,
               trace_id: int = 0) -> None:
        tid = trace_id if TRACER.enabled else 0
        t0 = TRACER.now() if tid else 0
        # encode on the CALLING (division) loop: serialization stays off
        # the connection's loop, which only performs the buffered write
        body = reply.to_bytes()
        frame = _encode_frame(call_seq, KIND_REPLY, body)
        with self._lock:
            self._q.append((frame, tid, t0, len(body)))
            if self._armed:
                return
            self._armed = True
        hop("reply_flush")
        try:
            self._loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            pass  # connection loop closed: the client sees a torn socket

    def _drain(self) -> None:
        with self._lock:
            items = list(self._q)
            self._q.clear()
            self._armed = False
        now = TRACER.now() if TRACER.enabled else 0
        for frame, tid, t0, nbody in items:
            try:
                self._conn_out.send_nowait(frame, len(frame))
            except Exception:
                return  # connection dead; remaining frames undeliverable
            if tid and t0:
                # respond span (deferred shape): reply ready at the
                # division -> handed to this connection's batched write
                # path (the flush itself is the coalescer's single
                # write+drain per batch)
                TRACER.record(tid, STAGE_RESPOND, t0, now, tag=nbody)


async def _read_frame(reader: asyncio.StreamReader):
    """(call_seq, kind, body) or None on clean EOF."""
    try:
        prefix = await reader.readexactly(4)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ConnectionError("truncated frame") from None
    (length,) = struct.unpack(">I", prefix)
    if length < 9 or length > MAX_FRAME:
        raise ConnectionError(f"bad frame length {length}")
    body = await reader.readexactly(length)
    _, call_seq, kind = _FRAME.unpack(prefix + body[:9])
    return call_seq, kind, body[9:]


class TcpTlsConfig:
    """TLS for the raw-TCP transport (NettyConfigKeys.Tls): same parameter
    surface as the gRPC GrpcTlsConfig — cert chain + key server-side,
    optional trust root, optional mutual auth — applied as ssl contexts on
    asyncio start_server / open_connection."""

    def __init__(self, cert_chain_path=None, private_key_path=None,
                 trust_root_path=None, mutual_auth=False):
        self.cert_chain_path = cert_chain_path
        self.private_key_path = private_key_path
        self.trust_root_path = trust_root_path
        self.mutual_auth = mutual_auth

    @staticmethod
    def from_properties(p) -> "TcpTlsConfig | None":
        from ratis_tpu_torch.conf.keys import NettyConfigKeys
        if p is None or not NettyConfigKeys.Tls.enabled(p):
            return None
        cfg = TcpTlsConfig(
            cert_chain_path=NettyConfigKeys.Tls.cert_chain(p),
            private_key_path=NettyConfigKeys.Tls.private_key(p),
            trust_root_path=NettyConfigKeys.Tls.trust_root(p),
            mutual_auth=NettyConfigKeys.Tls.mutual_auth(p))
        if not cfg.trust_root_path:
            # Once per configuration, not per connection: encryption without
            # server authentication is a silent downgrade (MITM-able); the
            # gRPC path refuses to run without explicit cert material.
            LOG.warning(
                "TLS enabled WITHOUT a trust root (*.tls.trust.root.path "
                "unset): connections are encrypted but the server is NOT "
                "authenticated — configure a trust root for production")
        return cfg

    def server_context(self):
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_chain_path, self.private_key_path)
        if self.trust_root_path:
            ctx.load_verify_locations(self.trust_root_path)
        if self.mutual_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self):
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        # cluster-internal trust root, not the system store; hostname
        # checks are disabled because peers dial each other by raw IP
        ctx.check_hostname = False
        if self.trust_root_path:
            ctx.load_verify_locations(self.trust_root_path)
            ctx.verify_mode = ssl.CERT_REQUIRED
        else:
            # no trust root: encrypted but unauthenticated — warned once at
            # from_properties time
            ctx.verify_mode = ssl.CERT_NONE
        if self.mutual_auth and self.cert_chain_path:
            ctx.load_cert_chain(self.cert_chain_path, self.private_key_path)
        return ctx


class _Connection:
    """One outbound connection multiplexing calls by sequence number
    (reference NettyRpcProxy channel)."""

    def __init__(self, address: str, tls=None,
                 flush_bytes: int = 0, flush_micros: int = 0) -> None:
        self.address = address
        self._tls = tls
        self._flush_bytes = flush_bytes
        self._flush_micros = flush_micros
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._out: Optional[_StreamFrameCoalescer] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._dead: Optional[Exception] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None  # at connect

    async def connect(self) -> None:
        self.loop = asyncio.get_running_loop()
        host, port = self.address.rsplit(":", 1)
        ssl_ctx = self._tls.client_context() if self._tls is not None else None
        self._reader, self._writer = await asyncio.open_connection(
            host, int(port), ssl=ssl_ctx)
        self._out = _StreamFrameCoalescer(self._writer, self._flush_bytes,
                                          self._flush_micros)
        self._recv_task = asyncio.create_task(
            self._recv_loop(), name=f"tcp-rpc-recv-{self.address}")

    async def _recv_loop(self) -> None:
        cause: Exception = ConnectionError(f"{self.address} closed")
        try:
            while True:
                frame = await _read_frame(self._reader)
                if frame is None:
                    break
                call_seq, kind, body = frame
                fut = self._pending.pop(call_seq, None)
                if fut is not None and not fut.done():
                    fut.set_result((kind, body))
        except (ConnectionError, OSError, asyncio.CancelledError) as e:
            cause = ConnectionError(f"{self.address} lost: {e}")
        finally:
            self._dead = cause
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(cause)
            self._pending.clear()

    @property
    def alive(self) -> bool:
        return (self._writer is not None and self._dead is None
                and not self._out.poisoned)

    async def call(self, kind: int, body: bytes,
                   timeout_s: float) -> tuple[int, bytes]:
        if self._dead is not None:
            raise self._dead
        seq = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        frame = _encode_frame(seq, kind, body)
        try:
            await self._out.send(frame, len(frame))
        except BaseException:
            self._pending.pop(seq, None)
            raise
        try:
            return await asyncio.wait_for(fut, timeout_s)
        except asyncio.TimeoutError:
            self._pending.pop(seq, None)
            raise TimeoutIOException(
                f"rpc to {self.address} timed out after {timeout_s}s") \
                from None

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except asyncio.CancelledError:
                pass
        if self._out is not None:
            # flush-on-close: frames already queued must reach the wire
            await self._out.aclose()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class _ConnectionPool:
    """(calling loop, address) -> cached connection; reconnects dead ones
    on demand.

    Keyed per loop on purpose: with loop sharding
    (raft.tpu.server.loop-shards) divisions pinned to worker loops send
    through this pool from their own threads, and an asyncio connection
    (StreamWriter, drain waiters, recv task) is loop-affine — so each
    shard dials its own connection per destination, which also gives each
    shard an independent send pipe instead of one shared serialized
    writer.  Single-loop runtimes see exactly the old one-connection-per-
    address behavior."""

    def __init__(self, tls=None, flush_bytes: int = 0,
                 flush_micros: int = 0) -> None:
        self._conns: Dict[tuple[int, str], _Connection] = {}
        self._locks: Dict[tuple[int, str], asyncio.Lock] = {}
        self._tls = tls
        self._flush_bytes = flush_bytes
        self._flush_micros = flush_micros

    async def get(self, address: str) -> _Connection:
        key = (id(asyncio.get_running_loop()), address)
        lock = self._locks.setdefault(key, asyncio.Lock())
        async with lock:
            conn = self._conns.get(key)
            if conn is not None and conn.alive:
                return conn
            if conn is not None:
                await conn.close()
            conn = _Connection(address, tls=self._tls,
                               flush_bytes=self._flush_bytes,
                               flush_micros=self._flush_micros)
            await conn.connect()
            self._conns[key] = conn
            return conn

    async def close(self) -> None:
        conns = list(self._conns.values())
        self._conns.clear()
        self._locks.clear()
        try:
            current = asyncio.get_running_loop()
        except RuntimeError:
            current = None
        for conn in conns:
            if conn.loop is None or conn.loop is current:
                await conn.close()
            elif conn.loop.is_running():
                # shard-owned connection: its recv task and writer must be
                # unwound on the loop they live on
                try:
                    await asyncio.wrap_future(
                        asyncio.run_coroutine_threadsafe(conn.close(),
                                                         conn.loop))
                except Exception:
                    pass  # connection already broken; socket dies with it
            else:
                # owner loop gone (test teardown): close the raw transport
                # so the fd is released; tasks on the dead loop never run
                if conn._writer is not None:
                    conn._writer.close()


class TcpServerTransport(ServerTransport):
    """Single listening port serving both the consensus union and client
    requests (reference NettyRpcService envelope dispatch)."""

    def __init__(self, peer_id: RaftPeerId, address: str,
                 server_handler: ServerRpcHandler,
                 client_handler: ClientRequestHandler,
                 peer_resolver: Optional[Callable[[RaftPeerId],
                                                  Optional[str]]] = None,
                 request_timeout_s: float = 3.0,
                 tls: "TcpTlsConfig | None" = None,
                 flush_bytes: int = 0, flush_micros: int = 0,
                 defer_replies: bool = False, chaos: bool = False):
        self.peer_id = peer_id
        self._address = address
        self._bound_port: Optional[int] = None
        self.server_handler = server_handler
        self.client_handler = client_handler
        self.peer_resolver = peer_resolver
        self.request_timeout_s = request_timeout_s
        # chaos link-fault gate (raft.tpu.chaos.enabled): when armed,
        # server RPC sends consult the process-wide link-fault table
        # (ratis_tpu_torch.chaos.link) — partitions/latency/drop on real sockets
        self.chaos = chaos
        self.tls = tls
        self.flush_bytes = flush_bytes
        self.flush_micros = flush_micros
        # commit fan-out collapse: attach a per-connection deferred-reply
        # sink to client requests (the division decides per request
        # whether to engage it; see _DeferredReplyFanout)
        self.defer_replies = defer_replies
        self._server: Optional[asyncio.AbstractServer] = None
        self._pool = _ConnectionPool(tls=tls, flush_bytes=flush_bytes,
                                     flush_micros=flush_micros)
        self._accepted: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        host, port = self._address.rsplit(":", 1)
        ssl_ctx = self.tls.server_context() if self.tls is not None else None
        self._server = await asyncio.start_server(self._on_connect, host,
                                                  int(port), ssl=ssl_ctx)
        self._bound_port = self._server.sockets[0].getsockname()[1]

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._accepted.add(writer)
        # per-connection reply coalescer: concurrent _serve_one replies
        # fold into one buffered flush + one drain per batch
        conn_out = _StreamFrameCoalescer(writer, self.flush_bytes,
                                         self.flush_micros)
        fanout = (_DeferredReplyFanout(conn_out, asyncio.get_running_loop())
                  if self.defer_replies else None)
        tasks: set[asyncio.Task] = set()
        try:
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    break
                # handle concurrently: one slow consensus RPC must not
                # head-of-line-block the connection (gRPC gives this for
                # free; here we spawn per-call tasks)
                t = asyncio.create_task(
                    self._serve_one(frame, conn_out, fanout))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (ConnectionError, OSError):
            pass
        finally:
            for t in tasks:
                t.cancel()
            try:
                await conn_out.aclose()  # flush-on-close: queued replies
            except (ConnectionError, OSError):
                pass
            self._accepted.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_one(self, frame, conn_out: _StreamFrameCoalescer,
                         fanout: "Optional[_DeferredReplyFanout]" = None
                         ) -> None:
        call_seq, kind, body = frame
        trace_tid = trace_egress = 0
        client_reply = False
        try:
            if kind == KIND_SERVER_RPC:
                reply = await self.server_handler(decode_rpc(body))
                out_kind, out = KIND_REPLY, encode_rpc(reply)
            elif kind == KIND_CLIENT_REQUEST:
                t0 = TRACER.now() if TRACER.enabled else 0
                request = RaftClientRequest.from_bytes(body)
                if t0 and request.trace_id:
                    now = TRACER.now()
                    TRACER.record(request.trace_id, STAGE_DECODE, t0,
                                  now, tag=len(body))
                    INGRESS_NS.set(now)  # route span starts post-decode
                if fanout is not None:
                    attach_reply_sink(
                        request, fanout.sink_for(call_seq,
                                                 request.trace_id))
                reply = await self.client_handler(request)
                if reply is DEFERRED_REPLY:
                    # reply rides the per-connection fan-out batcher at
                    # commit; this task is done at append time
                    return
                trace_tid = request.trace_id
                trace_egress = TRACER.pop_egress(trace_tid)
                client_reply = True
                out_kind, out = KIND_REPLY, reply.to_bytes()
            else:
                raise RaftException(f"unexpected frame kind {kind}")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            LOG.warning("%s tcp rpc failed: %s", self.peer_id, e)
            exc = e if isinstance(e, RaftException) else RaftException(str(e))
            import msgpack
            out_kind, out = KIND_ERROR, msgpack.packb(
                exception_to_wire(exc), use_bin_type=True)
        try:
            if client_reply:
                # per-request commit->reply hop #3 (legacy path): this
                # task suspends for the send/drain — the deferred-reply
                # fan-out replaces it with one drain arm per connection
                # per burst (metrics/hops.py reply_send vs reply_flush)
                hop("reply_send")
            reply_frame = _encode_frame(call_seq, out_kind, out)
            await conn_out.send(reply_frame, len(reply_frame))
            if trace_egress:
                # handler done -> reply serialized, framed, and drained to
                # the socket (possibly as part of a coalesced batch): the
                # real "reply write" cost on this transport — the respond
                # span stays attributed across the coalesced flush
                TRACER.record(trace_tid, STAGE_RESPOND, trace_egress,
                              TRACER.now(), tag=len(out))
        except (ConnectionError, OSError):
            pass

    async def send_server_rpc(self, to: RaftPeerId, msg) -> object:
        address = self.peer_resolver(to) if self.peer_resolver else None
        if address is None:
            raise RaftException(f"unknown peer {to}")
        faults = None
        if self.chaos:
            from ratis_tpu_torch.chaos.link import link_faults
            faults = link_faults()
            if faults:
                await faults.gate(self.peer_id, to)
        try:
            conn = await self._pool.get(address)
            kind, body = await conn.call(KIND_SERVER_RPC, encode_rpc(msg),
                                         self.request_timeout_s)
        except (ConnectionError, OSError) as e:
            raise TimeoutIOException(f"{self.peer_id}->{to}: {e}") from None
        if faults:
            # the reply hop can be degraded independently (asymmetric
            # partitions): the peer processed the RPC but we never hear it
            await faults.gate(to, self.peer_id)
        if kind == KIND_ERROR:
            raise _decode_error(body)
        return decode_rpc(body)

    @property
    def address(self) -> str:
        if self._bound_port and self._address.endswith(":0"):
            host = self._address.rsplit(":", 1)[0]
            return f"{host}:{self._bound_port}"
        return self._address

    async def close(self) -> None:
        await self._pool.close()
        for writer in list(self._accepted):
            writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


def _decode_error(body: bytes) -> RaftException:
    import msgpack
    try:
        return exception_from_wire(msgpack.unpackb(body, raw=False))
    except Exception:
        return RaftException(f"undecodable remote error ({len(body)}B)")


class TcpClientTransport(ClientTransport):
    def __init__(self, request_timeout_s: float = 30.0,
                 tls: "TcpTlsConfig | None" = None,
                 flush_bytes: int = 0, flush_micros: int = 0):
        self._pool = _ConnectionPool(tls=tls, flush_bytes=flush_bytes,
                                     flush_micros=flush_micros)
        self.request_timeout_s = request_timeout_s

    async def send_request(self, peer_address: str,
                           request: RaftClientRequest) -> RaftClientReply:
        timeout = (request.timeout_ms / 1000.0 if request.timeout_ms > 0
                   else self.request_timeout_s)
        tid = request.trace_id if TRACER.enabled else 0
        try:
            conn = await self._pool.get(peer_address)
            t0 = TRACER.now() if tid else 0
            payload = request.to_bytes()
            if tid:
                TRACER.record(tid, STAGE_ENCODE, t0, TRACER.now(),
                              tag=len(payload))
                t0 = TRACER.now()
            kind, body = await conn.call(KIND_CLIENT_REQUEST, payload,
                                         timeout)
            if tid:
                # socket write + server + reply read: overlaps the server
                # stages — the wire share is this minus the server tiling
                TRACER.record(tid, STAGE_WIRE, t0, TRACER.now(),
                              tag=len(body))
        except (ConnectionError, OSError) as e:
            raise TimeoutIOException(f"client->{peer_address}: {e}") from None
        if kind == KIND_ERROR:
            raise _decode_error(body)
        return RaftClientReply.from_bytes(body)

    async def close(self) -> None:
        await self._pool.close()


class TcpTransportFactory(TransportFactory):
    def new_server_transport(self, peer_id: RaftPeerId, address: str,
                             server_handler, client_handler, properties=None,
                             peer_resolver=None) -> ServerTransport:
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        timeout_s = 3.0
        if properties is not None:
            timeout_s = RaftServerConfigKeys.Rpc.request_timeout(
                properties).seconds
        fb, fm = _flush_conf(properties)
        chaos = (properties is not None
                 and RaftServerConfigKeys.Chaos.enabled(properties))
        return TcpServerTransport(peer_id, address, server_handler,
                                  client_handler, peer_resolver=peer_resolver,
                                  request_timeout_s=timeout_s,
                                  tls=TcpTlsConfig.from_properties(properties),
                                  flush_bytes=fb, flush_micros=fm,
                                  defer_replies=_defer_conf(properties),
                                  chaos=chaos)

    def new_client_transport(self, properties=None) -> ClientTransport:
        fb, fm = _flush_conf(properties)
        return TcpClientTransport(tls=TcpTlsConfig.from_properties(properties),
                                  flush_bytes=fb, flush_micros=fm)


TransportFactory.register("NETTY", TcpTransportFactory())
TransportFactory.register("TCP", TcpTransportFactory())
