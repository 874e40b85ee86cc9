"""gRPC transport: the real-network RPC backend (asyncio, grpc.aio).

Capability parity with the reference gRPC transport (ratis-grpc/
GrpcFactory.java, server/GrpcServicesImpl.java:56, GrpcServerProtocolService
:46, client/GrpcClientRpc): one server endpoint per RaftServer carrying all
groups' traffic, with

- a server-to-server service (requestVote / appendEntries / installSnapshot
  / readIndex / startLeaderElection),
- a client service (all RaftClientRequest types incl. admin).

Transport-format difference by design: instead of compiled protobuf stubs
the services are grpc *generic* handlers over the framework's tagged msgpack
envelope (protocol.raftrpc.encode_rpc — the same union shape as the
reference's Netty.proto:31-48), so every transport shares one codec and the
wire layer needs no generated code.  Peer channels are cached per address
(reference PeerProxyMap / GrpcServerProtocolClient).
"""

from __future__ import annotations

import asyncio
import logging
import pathlib
import time
from typing import Callable, Optional

import grpc
import grpc.aio
import msgpack

from ratis_tpu_torch.metrics.hops import hop
from ratis_tpu_torch.protocol.exceptions import RaftException, TimeoutIOException
from ratis_tpu_torch.protocol.ids import RaftPeerId
from ratis_tpu_torch.protocol.raftrpc import (AppendEntriesRequest, AppendEnvelope,
                                        decode_rpc, encode_rpc)
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

SERVER_SERVICE = "ratis_tpu_torch.RaftServerProtocol"
CLIENT_SERVICE = "ratis_tpu_torch.RaftClientProtocol"
_RPC_METHOD = f"/{SERVER_SERVICE}/rpc"
_APPEND_STREAM_METHOD = f"/{SERVER_SERVICE}/appendStream"
_REQUEST_METHOD = f"/{CLIENT_SERVICE}/request"
_REQUEST_STREAM_METHOD = f"/{CLIENT_SERVICE}/requestStream"

# append-stream envelope status codes
_ST_OK = 0
_ST_RAFT_ERROR = 1
_ST_INTERNAL = 2


class GrpcTlsConfig:
    """TLS parameters (reference GrpcTlsConfig, ratis-grpc/.../GrpcTlsConfig):
    cert chain + private key for the server side, an optional trust root for
    verifying peers/servers, optional mutual auth."""

    def __init__(self, cert_chain_path: Optional[str] = None,
                 private_key_path: Optional[str] = None,
                 trust_root_path: Optional[str] = None,
                 mutual_auth: bool = False,
                 target_name_override: Optional[str] = None):
        self.cert_chain_path = cert_chain_path
        self.private_key_path = private_key_path
        self.trust_root_path = trust_root_path
        self.mutual_auth = mutual_auth
        # test/dev certs are rarely issued for raw IPs; this maps to
        # grpc.ssl_target_name_override
        self.target_name_override = target_name_override

    @staticmethod
    def from_properties(p) -> Optional["GrpcTlsConfig"]:
        from ratis_tpu_torch.conf.keys import GrpcConfigKeys
        if p is None or not GrpcConfigKeys.Tls.enabled(p):
            return None
        return GrpcTlsConfig(
            cert_chain_path=GrpcConfigKeys.Tls.cert_chain(p),
            private_key_path=GrpcConfigKeys.Tls.private_key(p),
            trust_root_path=GrpcConfigKeys.Tls.trust_root(p),
            mutual_auth=GrpcConfigKeys.Tls.mutual_auth(p),
            target_name_override=GrpcConfigKeys.Tls.name_override(p))

    @staticmethod
    def admin_from_properties(p) -> Optional["GrpcTlsConfig"]:
        """The admin endpoint's own TLS block (reference admin
        GrpcTlsConfig, GrpcServicesImpl.java:56,219-224); falls back to the
        main Tls block when not separately enabled."""
        from ratis_tpu_torch.conf.keys import GrpcConfigKeys
        if p is None or not GrpcConfigKeys.AdminTls.enabled(p):
            return GrpcTlsConfig.from_properties(p)
        return GrpcTlsConfig(
            cert_chain_path=GrpcConfigKeys.AdminTls.cert_chain(p),
            private_key_path=GrpcConfigKeys.AdminTls.private_key(p),
            trust_root_path=GrpcConfigKeys.AdminTls.trust_root(p),
            mutual_auth=GrpcConfigKeys.AdminTls.mutual_auth(p),
            target_name_override=GrpcConfigKeys.Tls.name_override(p))

    def _read(self, path: Optional[str]) -> Optional[bytes]:
        return pathlib.Path(path).read_bytes() if path else None

    def server_credentials(self) -> grpc.ServerCredentials:
        return grpc.ssl_server_credentials(
            [(self._read(self.private_key_path),
              self._read(self.cert_chain_path))],
            root_certificates=self._read(self.trust_root_path),
            require_client_auth=self.mutual_auth)

    def channel_credentials(self) -> grpc.ChannelCredentials:
        return grpc.ssl_channel_credentials(
            root_certificates=self._read(self.trust_root_path),
            private_key=(self._read(self.private_key_path)
                         if self.mutual_auth else None),
            certificate_chain=(self._read(self.cert_chain_path)
                               if self.mutual_auth else None))

    def channel_options(self) -> list:
        if self.target_name_override:
            return [("grpc.ssl_target_name_override",
                     self.target_name_override)]
        return []

# Generous bounds: appenders batch up to the configured buffer byte limit,
# snapshot chunks up to snapshot.chunk.size.max (16MB default).
_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    # A multi-raft host's event loop legitimately stalls for seconds
    # (deliberate GC seal, cold jit compile); default HTTP/2 ping/settings
    # deadlines then GOAWAY every connection at once, and the mass
    # reconnect allocates so much that the NEXT collector pass is even
    # longer — a measured death spiral at 1024 co-hosted groups.  Be
    # generous: consensus liveness has its own (election) timers.
    ("grpc.keepalive_timeout_ms", 60_000),
    ("grpc.http2.ping_timeout_ms", 60_000),
    ("grpc.http2.settings_timeout", 60_000),
]

_identity = lambda b: b  # noqa: E731  (bytes in/out; codecs are ours)

# Status codes that mean "transient — retry/failover"; everything else is a
# deterministic failure surfaced to the caller.
_TRANSIENT_CODES = frozenset((grpc.StatusCode.UNAVAILABLE,
                              grpc.StatusCode.DEADLINE_EXCEEDED,
                              grpc.StatusCode.CANCELLED))


class _ChannelPool:
    """address -> aio channel cache with cached multicallables
    (reference PeerProxyMap; building a fresh multicallable per call was
    measurable overhead on the append hot path)."""

    def __init__(self, tls: Optional[GrpcTlsConfig] = None):
        self._channels: dict[str, grpc.aio.Channel] = {}
        self._unary: dict[tuple[str, str], object] = {}
        self._stream: dict[tuple[str, str], object] = {}
        self._tls = tls

    def get(self, address: str) -> grpc.aio.Channel:
        ch = self._channels.get(address)
        if ch is None:
            if self._tls is not None:
                ch = grpc.aio.secure_channel(
                    address, self._tls.channel_credentials(),
                    options=_CHANNEL_OPTIONS + self._tls.channel_options())
            else:
                ch = grpc.aio.insecure_channel(address,
                                               options=_CHANNEL_OPTIONS)
            self._channels[address] = ch
        return ch

    def unary(self, address: str, method: str):
        key = (address, method)
        call = self._unary.get(key)
        if call is None:
            call = self.get(address).unary_unary(
                method, request_serializer=_identity,
                response_deserializer=_identity)
            self._unary[key] = call
        return call

    def stream(self, address: str, method: str):
        key = (address, method)
        call = self._stream.get(key)
        if call is None:
            call = self.get(address).stream_stream(
                method, request_serializer=_identity,
                response_deserializer=_identity)
            self._stream[key] = call
        return call

    async def close(self) -> None:
        self._unary.clear()
        self._stream.clear()
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()


class _StreamDialGate:
    """Per-address re-dial pacing for the shared bidi streams.  Without
    it, every pending send re-dials the instant a stream dies, and a
    transient stall (loop pause, peer GOAWAY) becomes a dial storm:
    thousands of grpc calls created per second, each leaving C-core
    operation objects behind — measured as multi-GB RSS growth and a
    drowned event loop.  One dial attempt per address per window; other
    senders fail fast as transient and retry through their normal paths."""

    WINDOW_S = 0.25

    def __init__(self):
        self._last: dict[str, float] = {}

    def may_dial(self, address: str) -> bool:
        now = time.monotonic()
        if now - self._last.get(address, 0.0) < self.WINDOW_S:
            return False
        self._last[address] = now
        return True


class _StreamChunkCoalescer(WriteCoalescer):
    """Stream-framing coalescing (VERDICT r5 item 6): one bidi stream
    message carries a BATCH of ``[call_id, payload]`` chunks, so grpc.aio's
    per-message Python+C-core cost is paid once per batch instead of once
    per append.  A single-chunk flush keeps the legacy wire shape (a bare
    pair), so with thresholds at 0 the stream framing is unchanged."""

    def __init__(self, call, flush_micros: int = 0, max_frames: int = 64):
        super().__init__(flush_micros=flush_micros, max_frames=max_frames)
        self._call = call

    async def _flush_batch(self, frames: list) -> None:
        # the coalescer's internal lock serializes flushes, which is the
        # overlapping-write serialization grpc core requires
        # (GRPC_CALL_ERROR_TOO_MANY_OPERATIONS)
        await self._call.write(msgpack.packb(
            frames[0] if len(frames) == 1 else frames))


class _DeferredStreamFanout:
    """Per-stream deferred-reply batcher (commit fan-out collapse on the
    gRPC bidi client stream — the transport analog of the TCP
    ``_DeferredReplyFanout``): the division's waterline fan-out calls
    :meth:`submit` synchronously (possibly from a shard loop); replies
    queue here and ONE armed callback per burst drains them into the
    stream's reply queue, where the generator's batch-what's-ready fold
    ships them — one scheduled hop per burst per stream instead of one
    handler-resume + reply-write chain per request."""

    __slots__ = ("_loop", "_replies", "_q", "_lock", "_armed")

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 replies: asyncio.Queue) -> None:
        import collections
        import threading
        self._loop = loop
        self._replies = replies
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._armed = False

    def sink_for(self, call_id: int, trace_id: int = 0):
        def sink(reply: RaftClientReply) -> None:
            self.submit(call_id, reply, trace_id)
        return sink

    def submit(self, call_id: int, reply: RaftClientReply,
               trace_id: int = 0) -> None:
        tid = trace_id if TRACER.enabled else 0
        t0 = TRACER.now() if tid else 0
        # encode on the CALLING (division) loop: serialization stays off
        # the stream's loop, which only forwards the finished chunks
        body = reply.to_bytes()
        with self._lock:
            self._q.append(([call_id, _ST_OK, body], tid, t0))
            if self._armed:
                return
            self._armed = True
        hop("reply_flush")
        try:
            self._loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            pass  # stream loop closed: the client sees a dead stream

    def _drain(self) -> None:
        with self._lock:
            items = list(self._q)
            self._q.clear()
            self._armed = False
        now = TRACER.now() if TRACER.enabled else 0
        backlog: list = []
        for out, tid, t0 in items:
            if backlog:
                backlog.append(out)
            else:
                try:
                    self._replies.put_nowait(out)
                except asyncio.QueueFull:
                    # reply order across call ids is irrelevant (replies
                    # are id-matched); overflow rides one catch-up task
                    backlog.append(out)
            if tid and t0:
                # respond span (deferred shape): reply ready at the
                # division -> handed to this stream's reply fold
                TRACER.record(tid, STAGE_RESPOND, t0, now, tag=len(out[2]))
        if backlog:
            self._loop.create_task(self._put_backlog(backlog))

    async def _put_backlog(self, outs: list) -> None:
        for out in outs:
            await self._replies.put(out)


class _AppendStreamClient:
    """One ordered bidi stream to a peer carrying entry-bearing
    AppendEntries (reference GrpcLogAppender's appendEntries stream,
    GrpcLogAppender.java:343: requests flow in order on one HTTP/2 stream,
    replies are matched back by a stream-local id).  Heartbeats keep using
    the unary path — the reference's separate heartbeat channel — so they
    never queue behind a full window of batches."""

    def __init__(self, multicallable, flush_micros: int = 0,
                 flush_chunks: int = 64):
        self._call = multicallable()
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self.closed = False
        # serializes writes (grpc core rejects overlapping write() ops on
        # one call) and, when flush_micros > 0, batches chunks into one
        # stream message per flush
        self._out = _StreamChunkCoalescer(self._call,
                                          flush_micros=flush_micros,
                                          max_frames=flush_chunks)
        self._reader = asyncio.create_task(self._read_loop())

    async def send(self, payload: bytes, timeout_s: float) -> bytes:
        if self.closed:
            raise TimeoutIOException("append stream closed")
        call_id = self._next_id
        self._next_id += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[call_id] = fut
        wrote = False

        async def _write_then_wait() -> bytes:
            nonlocal wrote
            await self._out.send([call_id, payload], len(payload) + 16)
            wrote = True
            return await fut

        try:
            # one deadline over write + reply: a flow-control-blocked write
            # (frozen peer, full HTTP/2 window) must also time out so the
            # appender's send slot frees and its window resets
            return await asyncio.wait_for(_write_then_wait(), timeout_s)
        except asyncio.TimeoutError:
            if not wrote and not self._out.coalescing:
                # the deadline cancelled the writer MID self._call.write():
                # the call may hold an abandoned core write op, and reusing
                # it breaks the overlapping-write serialization — this
                # stream is done (callers see .closed and re-dial); only
                # the reply-is-late case is safe to ride out.  With
                # coalescing on, the chunk was merely QUEUED and the
                # flusher task owns the core write — the stream stays
                # healthy and the late reply is dropped by the reader.
                self._fail(TimeoutIOException(
                    "append stream write timed out (flow-blocked peer)"))
            raise
        finally:
            self._pending.pop(call_id, None)

    def _dispatch_reply(self, call_id: int, status: int, payload) -> None:
        fut = self._pending.pop(call_id, None)
        if fut is None or fut.done():
            return
        if status == _ST_OK:
            fut.set_result(payload)
        elif status == _ST_RAFT_ERROR:
            fut.set_exception(RaftException(payload.decode()))
        else:
            fut.set_exception(TimeoutIOException(payload.decode()))

    async def _read_loop(self) -> None:
        try:
            async for chunk in self._call:
                decoded = msgpack.unpackb(chunk)
                if decoded and isinstance(decoded[0], (list, tuple)):
                    # coalesced reply batch: several [id, status, payload]
                    # triples in one stream message
                    for call_id, status, payload in decoded:
                        self._dispatch_reply(call_id, status, payload)
                else:
                    call_id, status, payload = decoded
                    self._dispatch_reply(call_id, status, payload)
        except asyncio.CancelledError:
            self._fail(ConnectionError("append stream closed"))
            raise
        except Exception as e:
            self._fail(e)
        else:
            self._fail(ConnectionError("append stream closed by peer"))

    def _fail(self, exc: Exception) -> None:
        self.closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    TimeoutIOException(f"append stream error: {exc}"))
        self._pending.clear()

    async def close(self) -> None:
        # fail in-flight sends NOW: they must not sit out their full
        # timeout on a stream we already know is dead
        self._fail(ConnectionError("append stream closed"))
        try:
            await self._out.aclose()
        except Exception:
            pass
        self._reader.cancel()
        try:
            await self._reader
        except (asyncio.CancelledError, Exception):
            pass
        try:
            # release the C-core call deterministically: a merely-abandoned
            # call keeps its operation objects (SendInitialMetadata /
            # ReceiveStatus / CallbackWrapper) alive until a GC pass, and a
            # re-dial storm accumulated tens of thousands of them (multi-GB
            # RSS measured)
            self._call.cancel()
        except Exception:
            pass


class GrpcServerTransport(ServerTransport):
    def __init__(self, peer_id: RaftPeerId, address: str,
                 server_handler: ServerRpcHandler,
                 client_handler: ClientRequestHandler,
                 peer_resolver: Optional[Callable[[RaftPeerId], Optional[str]]]
                 = None,
                 request_timeout_s: float = 3.0,
                 tls: Optional[GrpcTlsConfig] = None,
                 client_port: Optional[int] = None,
                 admin_port: Optional[int] = None,
                 admin_tls: Optional[GrpcTlsConfig] = None,
                 flush_micros: int = 0, flush_chunks: int = 64,
                 defer_replies: bool = False, chaos: bool = False):
        self.peer_id = peer_id
        # chaos link-fault gate (raft.tpu.chaos.enabled): armed server RPC
        # sends consult the process-wide link-fault table
        # (ratis_tpu_torch.chaos.link) — partitions/latency/drop over gRPC
        self.chaos = chaos
        # stream-framing coalescing (raft.tpu.grpc.*): 0µs = one chunk per
        # stream message, the pre-round-6 wire shape
        self.flush_micros = flush_micros
        self.flush_chunks = max(1, flush_chunks)
        # commit fan-out collapse (raft.tpu.replication.reply-fanout):
        # attach a per-stream deferred-reply sink to client requests so
        # replies ride the waterline fan-out instead of per-request
        # handler resumes (the TCP transport's defer_replies analog)
        self.defer_replies = defer_replies
        # observability for the keyed-FIFO dispatch + framing coalescing
        # (ADVICE r5: make reorder churn and batching measurable)
        self.dispatch_metrics = {"stream_chunks": 0, "keyed_chunks": 0,
                                 "ordered_waits": 0, "batched_messages": 0,
                                 "reply_batches": 0}
        self._address = address
        self._bound_port: Optional[int] = None
        # optional dedicated client/admin endpoint (GrpcServicesImpl's
        # separate client/admin ports); None = client service shares the
        # server-to-server port
        self.client_port = client_port
        self._client_server: Optional[grpc.aio.Server] = None
        self.bound_client_port: Optional[int] = None
        # optional THIRD endpoint serving ONLY admin request types, with its
        # own TLS config (GrpcServicesImpl.java:56,197-224)
        self.admin_port = admin_port
        self.admin_tls = admin_tls
        self._admin_server: Optional[grpc.aio.Server] = None
        self.bound_admin_port: Optional[int] = None
        self.server_handler = server_handler
        self.client_handler = client_handler
        self.peer_resolver = peer_resolver
        self.request_timeout_s = request_timeout_s
        self.tls = tls
        self._server: Optional[grpc.aio.Server] = None
        self._pool = _ChannelPool(tls)
        self._append_streams: dict[str, _AppendStreamClient] = {}
        self._dial_gate = _StreamDialGate()

    # ---------------------------------------------------------- service side

    async def _handle_rpc(self, request_bytes: bytes, context) -> bytes:
        try:
            msg = decode_rpc(request_bytes)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"undecodable rpc: {e}")
        try:
            reply = await self.server_handler(msg)
        except RaftException as e:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except Exception as e:
            LOG.exception("%s: server rpc failed", self.peer_id)
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        return encode_rpc(reply)

    async def _handle_client(self, request_bytes: bytes, context) -> bytes:
        try:
            request = RaftClientRequest.from_bytes(request_bytes)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"undecodable client request: {e}")
        reply = await self.client_handler(request)
        return reply.to_bytes()

    # bound on concurrently-processing chunks per inbound stream: enough to
    # keep every co-hosted group's append pipeline full, finite so a peer
    # cannot balloon the task set (HTTP/2 flow control bounds bytes, not
    # handler tasks)
    _STREAM_CONCURRENCY = 256

    async def _serve_stream(self, request_iterator, dispatch, classify=None,
                            defer: bool = False):
        """Shared server scaffold for the multiplexed bidi streams (append
        plane and client plane): chunks are handled CONCURRENTLY (a slow
        division flush must not head-of-line-block every co-hosted group
        riding the same stream — the same policy as the TCP transport's
        per-frame tasks) and replies carry the chunk's stream-local id, so
        they may complete out of order.

        ``classify(payload) -> (work, key)`` decodes/keys a chunk in the
        pump (arrival order); chunks sharing a non-None key dispatch in
        STRICT arrival order via a per-key completion chain — the keyed
        FIFO queue that closes ADVICE r5's reorder finding (same-group
        append chunks suspending at different await points could process
        out of arrival order and cause spurious INCONSISTENCY/rewind
        churn).  Distinct keys (and key None) stay fully concurrent.

        One inbound stream message may carry a coalesced BATCH of chunks
        (``raft.tpu.grpc.*``); replies batch the same way — everything
        ready in the reply queue folds into one stream message, zero added
        latency.  ``dispatch(work) -> reply bytes``; a RaftException maps
        to _ST_RAFT_ERROR, anything else to _ST_INTERNAL."""
        # BOUNDED reply queue: run_one blocks on put when the consumer (the
        # HTTP/2 send side) stalls, which keeps the gate held, which stops
        # the pump from accepting more chunks — end-to-end backpressure.
        # With an unbounded queue + release-on-enqueue, a peer that kept
        # writing while its read side lagged ballooned this server's heap
        # by the full reply backlog (measured: multi-GB RSS growth).
        replies: asyncio.Queue = asyncio.Queue(
            maxsize=self._STREAM_CONCURRENCY * 2)
        gate = asyncio.Semaphore(self._STREAM_CONCURRENCY)
        tasks: set[asyncio.Task] = set()
        last_by_key: dict[object, asyncio.Future] = {}
        metrics = self.dispatch_metrics
        # deferred-reply fan-out (commit fan-out collapse): dispatch gets
        # (fanout, call_id) and may return None — the reply arrives later
        # through the fanout's thread-safe drain into this reply queue
        fanout = (_DeferredStreamFanout(asyncio.get_running_loop(), replies)
                  if defer else None)

        async def run_one(call_id: int, work, prev, done) -> None:
            try:
                if prev is not None:
                    # keyed FIFO: wait out the predecessor chunk's dispatch
                    # (it always completes — set in its finally)
                    metrics["ordered_waits"] += 1
                    try:
                        await prev
                    except Exception:
                        pass
                try:
                    res = await (dispatch(work, (fanout, call_id))
                                 if fanout is not None else dispatch(work))
                    # None = deferred: the waterline fan-out delivers the
                    # reply through this stream's fanout at commit
                    out = (None if res is None
                           else [call_id, _ST_OK, res])
                except RaftException as e:
                    out = [call_id, _ST_RAFT_ERROR, str(e).encode()]
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    LOG.exception("%s: stream rpc failed", self.peer_id)
                    out = [call_id, _ST_INTERNAL, str(e).encode()]
                # unblock the successor BEFORE the (possibly backpressured)
                # reply enqueue: ordering is a dispatch guarantee, not a
                # reply-write guarantee
                if not done.done():
                    done.set_result(None)
                if out is not None:
                    await replies.put(out)
            finally:
                if not done.done():
                    done.set_result(None)
                gate.release()

        loop = asyncio.get_running_loop()

        async def enqueue(call_id: int, payload: bytes) -> None:
            metrics["stream_chunks"] += 1
            await gate.acquire()
            try:
                work, key = (classify(payload) if classify is not None
                             else (payload, None))
            except Exception as e:
                # undecodable chunk: report it on ITS call id instead of
                # killing the whole (shared, multi-group) stream
                await replies.put([call_id, _ST_INTERNAL,
                                   f"undecodable chunk: {e}".encode()])
                gate.release()
                return
            prev = None
            done = loop.create_future()
            if key is not None:
                metrics["keyed_chunks"] += 1
                prev = last_by_key.get(key)
                last_by_key[key] = done
                done.add_done_callback(
                    lambda f, k=key: (last_by_key.pop(k, None)
                                      if last_by_key.get(k) is f else None))
            t = asyncio.create_task(run_one(call_id, work, prev, done))
            tasks.add(t)
            t.add_done_callback(tasks.discard)

        async def pump() -> None:
            try:
                async for chunk in request_iterator:
                    try:
                        decoded = msgpack.unpackb(chunk)
                        if decoded and isinstance(decoded[0], (list, tuple)):
                            # coalesced batch of [call_id, payload] pairs
                            pairs = [(c, p) for c, p in decoded]
                        else:
                            c, p = decoded
                            pairs = [(c, p)]
                    except Exception as e:
                        # peer is garbling the FRAMING: stop reading — the
                        # stream ends and the sender re-dials.  Say WHY on
                        # this side (a bare break would leave both ends
                        # diagnosing a generic 'stream closed').
                        LOG.error("%s: undecodable stream chunk (%s); "
                                  "closing stream", self.peer_id, e)
                        break
                    if len(pairs) > 1:
                        metrics["batched_messages"] += 1
                    for call_id, payload in pairs:
                        await enqueue(call_id, payload)
            finally:
                # all accepted work must flush before the end marker
                for t in list(tasks):
                    try:
                        await t
                    except (asyncio.CancelledError, Exception):
                        pass
                # bounded: if the consumer is gone AND the queue is full
                # (stalled peer disconnect), an unbounded put would leak
                # this task + the reply backlog forever
                try:
                    await asyncio.wait_for(replies.put(None), 30.0)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    pass

        pump_task = asyncio.create_task(pump())
        coalesce_replies = self.flush_micros > 0
        try:
            finished = False
            while not finished:
                item = await replies.get()
                if item is None:
                    break
                if not coalesce_replies:
                    yield msgpack.packb(item)
                    continue
                # batch-what's-ready: fold every already-queued reply into
                # this stream message (no timed wait — zero added latency)
                batch = [item]
                while len(batch) < self.flush_chunks:
                    try:
                        nxt = replies.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is None:
                        finished = True
                        break
                    batch.append(nxt)
                if len(batch) > 1:
                    metrics["reply_batches"] += 1
                yield msgpack.packb(batch if len(batch) > 1 else batch[0])
        finally:
            pump_task.cancel()
            for t in list(tasks):
                t.cancel()

    async def _handle_append_stream(self, request_iterator, context):
        """Server side of the per-peer append stream
        (GrpcServerProtocolService.java:46 appendEntries stream observer).

        Unary (per-group) entry appends are KEYED by group id so same-group
        chunks dispatch in arrival order (scalar mode pipelines a window of
        them concurrently on this stream — the reorder surface ADVICE r5
        flagged).  SEQUENCED envelopes (append-window pipelining,
        raft.tpu.replication.window-depth > 1) are keyed by lane: their
        frames may share groups, and dispatching a lane's frames in stream
        arrival order keeps the server's lane intake on its buffer-free
        happy path.  Unsequenced envelopes stay unkeyed: their sender's
        depth-1 busy latch guarantees a group's items are never split
        across two in-flight envelopes, so those envelopes are
        group-disjoint and safely concurrent."""

        def classify(payload: bytes):
            msg = decode_rpc(payload)
            if isinstance(msg, AppendEntriesRequest) and msg.entries:
                return msg, ("g", msg.header.group_id.to_bytes())
            if isinstance(msg, AppendEnvelope) and msg.seq >= 0:
                return msg, ("l", msg.lane)
            return msg, None

        async def dispatch(msg) -> bytes:
            return encode_rpc(await self.server_handler(msg))

        async for item in self._serve_stream(request_iterator, dispatch,
                                             classify=classify):
            yield item

    async def _handle_client_stream(self, request_iterator, context):
        """Server side of the multiplexed client-request stream (reference
        GrpcClientProtocolService.java ordered stream): same id-matched
        concurrent-chunk shape as the append stream — one HTTP/2 stream per
        (client, server) instead of one per request, which is where
        grpc.aio's per-unary-call overhead was going at 1024 groups.

        With ``defer_replies`` (commit fan-out collapse,
        raft.tpu.replication.reply-fanout) each request gets a deferred
        reply sink into the stream's fan-out batcher: the handler chain
        ends at append time, and the commit waterline delivers the reply
        through one drained burst per stream — gRPC now rides the same
        collapsed reply plane as TCP and sim."""

        async def dispatch(payload: bytes, defer_ctx=None):
            t0 = TRACER.now() if TRACER.enabled else 0
            request = RaftClientRequest.from_bytes(payload)
            if t0 and request.trace_id:
                now = TRACER.now()
                TRACER.record(request.trace_id, STAGE_DECODE, t0,
                              now, tag=len(payload))
                INGRESS_NS.set(now)  # route span starts post-decode
            if defer_ctx is not None:
                fanout, call_id = defer_ctx
                attach_reply_sink(
                    request, fanout.sink_for(call_id, request.trace_id))
            reply = await self.client_handler(request)
            if reply is DEFERRED_REPLY:
                # reply rides the stream's fan-out batcher at commit;
                # this dispatch is done at append time
                return None
            reply_bytes = reply.to_bytes()
            egress = TRACER.pop_egress(request.trace_id)
            if egress:
                TRACER.record(request.trace_id, STAGE_RESPOND, egress,
                              TRACER.now(), tag=len(reply_bytes))
            return reply_bytes

        async for item in self._serve_stream(request_iterator, dispatch,
                                             defer=self.defer_replies):
            yield item

    def _client_handlers(self):
        return grpc.method_handlers_generic_handler(
            CLIENT_SERVICE,
            {"request": grpc.unary_unary_rpc_method_handler(
                self._handle_client, request_deserializer=_identity,
                response_serializer=_identity),
             "requestStream": grpc.stream_stream_rpc_method_handler(
                self._handle_client_stream, request_deserializer=_identity,
                response_serializer=_identity)})

    async def _handle_admin(self, request_bytes: bytes, context) -> bytes:
        """Admin endpoint: serves ONLY the admin request types; data-plane
        requests are rejected so the dedicated port is genuinely an admin
        plane (firewallable separately, like the reference's admin
        server)."""
        from ratis_tpu_torch.protocol.requests import RequestType
        try:
            request = RaftClientRequest.from_bytes(request_bytes)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"undecodable admin request: {e}")
        if request.type.type < RequestType.SET_CONFIGURATION:
            # admin types are the 8..14 block (SET_CONFIGURATION and up)
            await context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"{request.type.type.name} is not an admin operation")
        reply = await self.client_handler(request)
        return reply.to_bytes()

    def _admin_handlers(self):
        return grpc.method_handlers_generic_handler(
            CLIENT_SERVICE,
            {"request": grpc.unary_unary_rpc_method_handler(
                self._handle_admin, request_deserializer=_identity,
                response_serializer=_identity)})

    def _generic_handlers(self):
        server_handlers = grpc.method_handlers_generic_handler(
            SERVER_SERVICE,
            {"rpc": grpc.unary_unary_rpc_method_handler(
                self._handle_rpc, request_deserializer=_identity,
                response_serializer=_identity),
             "appendStream": grpc.stream_stream_rpc_method_handler(
                self._handle_append_stream, request_deserializer=_identity,
                response_serializer=_identity)})
        if self.client_port is not None:
            # dedicated client endpoint configured: the replication port
            # must NOT serve the client plane (that's the point of the
            # split — firewalling / isolation)
            return [server_handlers]
        return [server_handlers, self._client_handlers()]

    def _bind(self, server: grpc.aio.Server, address: str,
              tls: Optional[GrpcTlsConfig] = None) -> int:
        tls = tls if tls is not None else self.tls
        if tls is not None:
            return server.add_secure_port(address,
                                          tls.server_credentials())
        return server.add_insecure_port(address)

    async def start(self) -> None:
        # grpc.aio channels/streams are hard-bound to the loop that created
        # them; with server loop sharding, shard loops hop their sends here
        # (see send_server_rpc) instead of dialing per-loop channels
        self._home_loop = asyncio.get_running_loop()
        self._server = grpc.aio.server(options=_CHANNEL_OPTIONS)
        self._server.add_generic_rpc_handlers(self._generic_handlers())
        self._bound_port = self._bind(self._server, self._address)
        if self._bound_port == 0:
            raise RaftException(f"{self.peer_id}: cannot bind {self._address}")
        await self._server.start()
        if self.client_port is not None:
            # dedicated client/admin endpoint: client traffic cannot starve
            # (or be starved by) the replication plane
            try:
                host = self._address.rsplit(":", 1)[0]
                client_server = grpc.aio.server(options=_CHANNEL_OPTIONS)
                client_server.add_generic_rpc_handlers(
                    [self._client_handlers()])
                self.bound_client_port = self._bind(
                    client_server, f"{host}:{self.client_port}")
                if self.bound_client_port == 0:
                    raise RaftException(
                        f"{self.peer_id}: cannot bind client port "
                        f"{self.client_port}")
                await client_server.start()
                self._client_server = client_server
            except BaseException:
                # don't leak the already-listening servers: the caller's
                # close() is a no-op from the STARTING state, and the client
                # socket binds at add_*_port, before start()
                try:
                    await client_server.stop(grace=0)
                except Exception:
                    pass
                self.bound_client_port = None
                await self._server.stop(grace=0)
                self._server = None
                raise
        if self.admin_port is not None:
            # third endpoint: admin plane with its own TLS config
            try:
                host = self._address.rsplit(":", 1)[0]
                admin_server = grpc.aio.server(options=_CHANNEL_OPTIONS)
                admin_server.add_generic_rpc_handlers(
                    [self._admin_handlers()])
                self.bound_admin_port = self._bind(
                    admin_server, f"{host}:{self.admin_port}",
                    tls=self.admin_tls)
                if self.bound_admin_port == 0:
                    raise RaftException(
                        f"{self.peer_id}: cannot bind admin port "
                        f"{self.admin_port}")
                await admin_server.start()
                self._admin_server = admin_server
            except BaseException:
                try:
                    await admin_server.stop(grace=0)
                except Exception:
                    pass
                self.bound_admin_port = None
                if self._client_server is not None:
                    await self._client_server.stop(grace=0)
                    self._client_server = None
                await self._server.stop(grace=0)
                self._server = None
                raise
        LOG.info("%s: grpc bound %s%s%s%s", self.peer_id, self.address,
                 " (tls)" if self.tls is not None else "",
                 f" client-port {self.bound_client_port}"
                 if self._client_server is not None else "",
                 f" admin-port {self.bound_admin_port}"
                 if self._admin_server is not None else "")

    async def close(self) -> None:
        for stream in list(self._append_streams.values()):
            await stream.close()
        self._append_streams.clear()
        if self._admin_server is not None:
            await self._admin_server.stop(grace=0.2)
            self._admin_server = None
        if self._client_server is not None:
            await self._client_server.stop(grace=0.2)
            self._client_server = None
        if self._server is not None:
            await self._server.stop(grace=0.2)
            self._server = None
        await self._pool.close()

    # ----------------------------------------------------------- caller side

    def _resolve(self, to: RaftPeerId) -> str:
        addr = self.peer_resolver(to) if self.peer_resolver is not None else None
        if not addr:
            raise TimeoutIOException(f"{self.peer_id}: no address for peer {to}")
        return addr

    async def send_server_rpc(self, to: RaftPeerId, msg):
        home = getattr(self, "_home_loop", None)
        if home is not None:
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not home:
                # loop-sharded caller: grpc.aio state (channels, the shared
                # bidi append streams, dial gates) lives on the home loop —
                # hop there rather than duplicating C-core channels per
                # shard.  The gRPC transport therefore serializes SENDS
                # through one loop even when divisions are sharded; the TCP
                # transport is the per-shard-pipe one.
                cf = asyncio.run_coroutine_threadsafe(
                    self._send_server_rpc_on_home(to, msg), home)
                return await asyncio.wrap_future(cf)
        return await self._send_server_rpc_on_home(to, msg)

    async def _send_server_rpc_on_home(self, to: RaftPeerId, msg):
        address = self._resolve(to)
        if self.chaos:
            from ratis_tpu_torch.chaos.link import link_faults
            faults = link_faults()
            if faults:
                # one gate covers the round trip on this transport: the
                # unary/stream reply rides the same HTTP/2 connection, and
                # the runner models asymmetric reply loss by faulting the
                # (to, self) direction — which gates the peer's own sends
                # and this sender's next forward hop equally
                await faults.gate(self.peer_id, to)
                await faults.gate(to, self.peer_id)
        # The DATA PLANE — entry-bearing appends and coalesced multi-group
        # envelopes — rides the long-lived per-peer bidi stream: one HTTP/2
        # stream amortizes grpc.aio's per-unary-call setup across every
        # append to that peer (the reference's GrpcLogAppender stream,
        # GrpcLogAppender.java:343; measured here, unary envelopes capped
        # gRPC at ~half of the TCP transport's throughput).  Votes,
        # snapshots and heartbeats stay unary — low-rate, and heartbeats
        # must never queue behind a full append window.
        if (isinstance(msg, AppendEnvelope)
                or (isinstance(msg, AppendEntriesRequest) and msg.entries)):
            return await self._send_via_stream(to, address, msg)
        call = self._pool.unary(address, _RPC_METHOD)
        try:
            reply_bytes = await call(encode_rpc(msg),
                                     timeout=self.request_timeout_s)
        except grpc.aio.AioRpcError as e:
            if e.code() in _TRANSIENT_CODES:
                # Keep the shared channel: grpc.aio reconnects by itself,
                # while close() would cancel concurrent in-flight RPCs to
                # this peer (e.g. a snapshot chunk riding the same channel).
                raise TimeoutIOException(
                    f"{self.peer_id}->{to} {e.code().name}: {e.details()}") \
                    from None
            raise RaftException(
                f"{self.peer_id}->{to} rpc failed {e.code().name}: "
                f"{e.details()}") from None
        return decode_rpc(reply_bytes)

    async def _send_via_stream(self, to: RaftPeerId, address: str, msg):
        stream = self._append_streams.get(address)
        if stream is None or stream.closed:
            if not self._dial_gate.may_dial(address):
                raise TimeoutIOException(
                    f"{self.peer_id}->{to} append stream re-dial pacing")
            if stream is not None:
                # release the dead stream's C-core call before replacing it
                # (it may have failed via _fail without anyone closing it)
                await stream.close()
            stream = _AppendStreamClient(
                lambda: self._pool.stream(address, _APPEND_STREAM_METHOD)(),
                flush_micros=self.flush_micros,
                flush_chunks=self.flush_chunks)
            self._append_streams[address] = stream
        try:
            reply_bytes = await stream.send(encode_rpc(msg),
                                            self.request_timeout_s)
        except (RaftException, TimeoutIOException):
            raise
        except asyncio.TimeoutError:
            # ONE call's deadline elapsed on an otherwise-live stream (busy
            # peer / loaded loop).  Do NOT tear the stream down: it is
            # shared by every in-flight append to this peer, and killing it
            # fails them ALL — measured at 1024 gRPC groups, that turned
            # one slow reply into a redial storm that collapsed bring-up.
            # The reader simply drops the late reply when it arrives.
            # Exception: a MID-WRITE timeout already failed the stream
            # (abandoned core write op — unsafe to reuse); drop it.
            if stream.closed:
                if self._append_streams.get(address) is stream:
                    # guarded: a concurrent sender may have re-dialed a
                    # HEALTHY replacement — evicting that would orphan its
                    # call un-cancelled
                    self._append_streams.pop(address, None)
                await stream.close()
            raise TimeoutIOException(
                f"{self.peer_id}->{to} append stream call timed out"
            ) from None
        except Exception as e:
            # stream-level failure (write error, reader death): drop it so
            # the next send re-dials, surface as transient so the appender
            # resets its window
            if self._append_streams.get(address) is stream:
                self._append_streams.pop(address, None)
            await stream.close()
            raise TimeoutIOException(
                f"{self.peer_id}->{to} append stream: {e}") from None
        return decode_rpc(reply_bytes)

    @property
    def address(self) -> str:
        if self._bound_port and self._address.endswith(":0"):
            host = self._address.rsplit(":", 1)[0]
            return f"{host}:{self._bound_port}"
        return self._address


class GrpcClientTransport(ClientTransport):
    def __init__(self, request_timeout_s: float = 30.0,
                 tls: Optional[GrpcTlsConfig] = None,
                 flush_micros: int = 0, flush_chunks: int = 64):
        self._pool = _ChannelPool(tls)
        self.request_timeout_s = request_timeout_s
        self.flush_micros = flush_micros
        self.flush_chunks = max(1, flush_chunks)
        # address -> shared bidi request stream (one per server)
        self._streams: dict[str, _AppendStreamClient] = {}
        self._dial_gate = _StreamDialGate()

    async def send_request(self, peer_address: str,
                           request: RaftClientRequest) -> RaftClientReply:
        """Requests ride one long-lived bidi stream per server (reference
        GrpcClientProtocolService's ordered stream): the per-unary-call
        setup that dominated client-plane cost at high request rates is
        paid once per (client, server) instead of once per request."""
        timeout = (request.timeout_ms / 1000.0 if request.timeout_ms > 0
                   else self.request_timeout_s)
        from ratis_tpu_torch.protocol.requests import RequestType
        if request.type.type >= RequestType.SET_CONFIGURATION:
            # admin block stays unary: the dedicated admin endpoint serves
            # only the unary method (its filter aborts with grpc status
            # codes), and admin calls are low-rate anyway
            return await self._send_unary(peer_address, request, timeout)
        stream = self._streams.get(peer_address)
        if stream is None or stream.closed:
            if not self._dial_gate.may_dial(peer_address):
                raise TimeoutIOException(
                    f"client->{peer_address} request stream re-dial pacing")
            if stream is not None:
                await stream.close()  # release the dead stream's call
            stream = _AppendStreamClient(
                lambda: self._pool.stream(peer_address,
                                          _REQUEST_STREAM_METHOD)(),
                flush_micros=self.flush_micros,
                flush_chunks=self.flush_chunks)
            self._streams[peer_address] = stream
        tid = request.trace_id if TRACER.enabled else 0
        try:
            t0 = TRACER.now() if tid else 0
            payload = request.to_bytes()
            if tid:
                TRACER.record(tid, STAGE_ENCODE, t0, TRACER.now(),
                              tag=len(payload))
                t0 = TRACER.now()
            reply_bytes = await stream.send(payload, timeout)
            if tid:
                TRACER.record(tid, STAGE_WIRE, t0, TRACER.now(),
                              tag=len(reply_bytes))
        except (RaftException, TimeoutIOException):
            raise
        except asyncio.TimeoutError:
            # per-call deadline on a live stream: fail THIS call only (the
            # stream carries every other in-flight request to this server);
            # a mid-write timeout already failed the stream — drop it
            if stream.closed:
                if self._streams.get(peer_address) is stream:
                    self._streams.pop(peer_address, None)
                await stream.close()
            raise TimeoutIOException(
                f"client->{peer_address} request timed out") from None
        except Exception as e:
            if self._streams.get(peer_address) is stream:
                self._streams.pop(peer_address, None)
            await stream.close()
            raise TimeoutIOException(
                f"client->{peer_address} request stream: {e}") from None
        return RaftClientReply.from_bytes(reply_bytes)

    async def _send_unary(self, peer_address: str,
                          request: RaftClientRequest,
                          timeout: float) -> RaftClientReply:
        call = self._pool.unary(peer_address, _REQUEST_METHOD)
        try:
            reply_bytes = await call(request.to_bytes(), timeout=timeout)
        except grpc.aio.AioRpcError as e:
            if e.code() in _TRANSIENT_CODES:
                raise TimeoutIOException(
                    f"client->{peer_address} {e.code().name}: "
                    f"{e.details()}") from None
            raise RaftException(
                f"client->{peer_address} rpc failed {e.code().name}: "
                f"{e.details()}") from None
        return RaftClientReply.from_bytes(reply_bytes)

    async def close(self) -> None:
        for stream in list(self._streams.values()):
            await stream.close()
        self._streams.clear()
        await self._pool.close()


def _grpc_flush_conf(properties) -> tuple[int, int]:
    """(flush_micros, flush_chunks) for the stream framing; (0, 64) — one
    chunk per stream message — when unconfigured."""
    if properties is None:
        return 0, 64
    from ratis_tpu_torch.conf.keys import WireConfigKeys
    return (WireConfigKeys.Grpc.flush_micros(properties),
            WireConfigKeys.Grpc.flush_chunks(properties))


def _grpc_defer_conf(properties) -> bool:
    """Whether client requests on the bidi stream get a deferred-reply
    sink attached (commit fan-out collapse; same gate as the TCP
    transport's)."""
    if properties is None:
        return False
    from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
    K = RaftServerConfigKeys.Replication
    return K.sweep(properties) and K.reply_fanout(properties)


class GrpcTransportFactory(TransportFactory):
    """The SupportedRpcType.GRPC factory (GrpcFactory.java)."""

    def new_server_transport(self, peer_id, address, server_handler,
                             client_handler, properties=None,
                             peer_resolver=None) -> ServerTransport:
        timeout_s = 3.0
        client_port = None
        if properties is not None:
            from ratis_tpu_torch.conf.keys import (GrpcConfigKeys,
                                             RaftServerConfigKeys)
            timeout_s = properties.get_time_duration(
                RaftServerConfigKeys.Rpc.REQUEST_TIMEOUT_KEY,
                RaftServerConfigKeys.Rpc.REQUEST_TIMEOUT_DEFAULT).seconds
            client_port = GrpcConfigKeys.client_port(properties)
        admin_port = (GrpcConfigKeys.admin_port(properties)
                      if properties is not None else None)
        fm, fc = _grpc_flush_conf(properties)
        chaos = False
        if properties is not None:
            from ratis_tpu_torch.conf.keys import RaftServerConfigKeys as _K
            chaos = _K.Chaos.enabled(properties)
        return GrpcServerTransport(peer_id, address, server_handler,
                                   client_handler, peer_resolver, timeout_s,
                                   tls=GrpcTlsConfig.from_properties(properties),
                                   client_port=client_port,
                                   admin_port=admin_port,
                                   admin_tls=GrpcTlsConfig.admin_from_properties(
                                       properties),
                                   flush_micros=fm, flush_chunks=fc,
                                   defer_replies=_grpc_defer_conf(properties),
                                   chaos=chaos)

    def new_client_transport(self, properties=None) -> ClientTransport:
        fm, fc = _grpc_flush_conf(properties)
        return GrpcClientTransport(
            tls=GrpcTlsConfig.from_properties(properties),
            flush_micros=fm, flush_chunks=fc)


TransportFactory.register("GRPC", GrpcTransportFactory())
