"""Prometheus text exposition + the per-server introspection endpoint.

Reference analog: ratis-metrics exposes dropwizard registries through
reporters (console/JMX, ratis-metrics-default); operators today scrape
Prometheus, so this renders every registry in
:class:`~ratis_tpu_torch.metrics.registry.MetricRegistries` in text exposition
format 0.0.4 and (optionally) serves it over a tiny dependency-free
asyncio HTTP endpoint.

Naming: ``ratis_<component>_<metric>`` with the registry prefix (the group
member id) as a ``member`` label, e.g.::

    ratis_server_numRequests_total{member="s0@group-1234"} 42
    ratis_log_worker_flushTime_seconds{member="...",quantile="0.99"} 0.003

Exposition conformance (asserted in tests/test_observability.py):

- counters carry the ``_total`` suffix and ``# TYPE ... counter``;
- all samples of one metric family are CONSECUTIVE (the 0.0.4 format
  requires it; the naive per-registry walk interleaved families when two
  members shared a catalog);
- label values escape backslash, double-quote, and newline;
- registry names of the form ``name{k="v"}`` (see
  :func:`ratis_tpu_torch.metrics.registry.labeled`) merge their labels with the
  ``member`` label — the framework's labeled-counter convention;
- timers render as ``summary`` in seconds, histograms (dimensionless
  reservoirs) as ``summary`` without a unit suffix.

Beyond ``/metrics`` the HTTP server takes extra JSON routes (``/health``,
``/divisions``, ``/events`` when wired by
:class:`~ratis_tpu_torch.server.server.RaftServer`): the per-server
introspection surface of the cluster observability plane.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Callable, Dict, Optional

from ratis_tpu_torch.metrics.registry import MetricRegistries

LOG = logging.getLogger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _split_labels(metric: str) -> tuple[str, str]:
    """``name{k="v"}`` -> (name, 'k="v"'); plain names -> (name, "")."""
    if "{" in metric and metric.endswith("}"):
        base, _, rest = metric.partition("{")
        return base, rest[:-1]
    return metric, ""


class _Families:
    """Collects samples grouped by metric family so one family's samples
    render consecutively regardless of how many registries feed it."""

    def __init__(self) -> None:
        self._order: list[str] = []
        self._kind: dict[str, str] = {}
        self._samples: dict[str, list[str]] = {}

    def add(self, family: str, kind: str, sample: str) -> None:
        if family not in self._samples:
            self._order.append(family)
            self._kind[family] = kind
            self._samples[family] = []
        self._samples[family].append(sample)

    def render(self) -> str:
        lines: list[str] = []
        for family in self._order:
            lines.append(f"# TYPE {family} {self._kind[family]}")
            lines.extend(self._samples[family])
        return "\n".join(lines) + "\n"


def render_text(registries: Optional[MetricRegistries] = None) -> str:
    """All registries in Prometheus text exposition format."""
    regs = registries or MetricRegistries.global_registries()
    fams = _Families()
    for info in regs.get_registry_infos():
        reg = regs.get(info)
        if reg is None:
            continue  # unregistered between listing and render (scrape race)
        member = _escape_label(info.prefix)
        base = f"{_sanitize(info.application)}_{_sanitize(info.component)}"
        for metric, (kind, value) in sorted(reg.typed_snapshot().items()):
            mbare, extra = _split_labels(metric)
            mname = f"{base}_{_sanitize(mbare)}"
            labels = f'member="{member}"' + (f",{extra}" if extra else "")
            if kind == "timer":
                fam = f"{mname}_seconds"
                fams.add(fam, "summary",
                         f'{fam}_count{{{labels}}} {value.get("count", 0)}')
                total = value.get("mean_s", 0.0) * value.get("count", 0)
                fams.add(fam, "summary",
                         f'{fam}_sum{{{labels}}} {_fmt(total)}')
                for key, q in (("p50_s", "0.5"), ("p99_s", "0.99")):
                    if key in value:
                        fams.add(fam, "summary",
                                 f'{fam}{{{labels},quantile="{q}"}} '
                                 f'{_fmt(value[key])}')
            elif kind == "histogram":
                fams.add(mname, "summary",
                         f'{mname}_count{{{labels}}} {value.get("count", 0)}')
                total = value.get("mean", 0.0) * value.get("count", 0)
                fams.add(mname, "summary",
                         f'{mname}_sum{{{labels}}} {_fmt(total)}')
                for key, q in (("p50", "0.5"), ("p99", "0.99")):
                    if key in value:
                        fams.add(mname, "summary",
                                 f'{mname}{{{labels},quantile="{q}"}} '
                                 f'{_fmt(value[key])}')
            elif kind == "counter":
                fam = (mname if mname.endswith("_total")
                       else f"{mname}_total")
                fams.add(fam, "counter", f'{fam}{{{labels}}} {_fmt(value)}')
            elif isinstance(value, dict):
                # structured gauge (e.g. the commitInfos index map): flatten
                # numeric sub-keys into per-key gauges
                for sub, sval in sorted(value.items()):
                    num = _as_number(sval)
                    if num is None:
                        continue
                    sub_name = f"{mname}_{_sanitize(str(sub))}"
                    fams.add(sub_name, "gauge",
                             f'{sub_name}{{{labels}}} {_fmt(num)}')
            else:
                num = _as_number(value)
                if num is None:
                    continue  # non-numeric gauge (e.g. an error string)
                fams.add(mname, "gauge", f'{mname}{{{labels}}} {_fmt(num)}')
    return fams.render()


def _fmt(num: float) -> str:
    """Full-precision rendering: integers verbatim (a counter past 1e9 must
    not collapse to 1e+09 and stall rate() queries), floats via repr."""
    if isinstance(num, int) or (isinstance(num, float) and num.is_integer()):
        return str(int(num))
    return repr(float(num))


def _as_number(value) -> Optional[float]:
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        return float(value)
    return None


# A JSON route returns any json.dumps-able object; exceptions become 500.
# A route taking a parameter receives the parsed query dict
# ({key: [values]}, urllib.parse.parse_qs) — /events?since= and
# /timeseries?since= poll incrementally through it.
JsonRoute = Callable[..., object]


class MetricsHttpServer:
    """Minimal asyncio HTTP introspection endpoint.

    Dependency-free on purpose (the environment bakes no prometheus
    client); the exposition format is line-oriented text, so a tiny
    handwritten responder is all a scraper needs.  ``GET /metrics`` (and
    ``/``) serve the Prometheus text; every entry in ``json_routes``
    (path -> supplier) serves ``application/json`` — the server wires
    ``/health``, ``/divisions``, and ``/events`` there."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registries: Optional[MetricRegistries] = None,
                 json_routes: Optional[Dict[str, JsonRoute]] = None):
        self.host = host
        self.port = port
        self.registries = registries
        self.json_routes: Dict[str, JsonRoute] = dict(json_routes or {})
        self._server: Optional[asyncio.AbstractServer] = None
        self.bound_port: Optional[int] = None

    @property
    def address(self) -> Optional[str]:
        if self.bound_port is None:
            return None
        return f"{self.host}:{self.bound_port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        LOG.info("metrics endpoint on http://%s:%d/metrics",
                 self.host, self.bound_port)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _render(self, path: str,
                query: Optional[dict] = None) -> tuple[bytes, bytes]:
        """(content-type, body) for ``path``; raises on handler bugs."""
        if path in ("/metrics", "/"):
            return (b"text/plain; version=0.0.4; charset=utf-8",
                    render_text(self.registries).encode())
        route = self.json_routes.get(path)
        if route is None:
            raise KeyError(path)
        import inspect
        try:
            takes_query = bool(inspect.signature(route).parameters)
        except (TypeError, ValueError):
            takes_query = False
        payload = route(query or {}) if takes_query else route()
        return (b"application/json",
                json.dumps(payload, default=str).encode())

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10.0)
            # drain headers
            while True:
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request_line.decode("latin-1").split()
            target = parts[1] if len(parts) >= 2 else "/"
            path, _, qs = target.partition("?")
            from urllib.parse import parse_qs
            query = parse_qs(qs) if qs else {}
            try:
                ctype, body = self._render(path, query)
            except KeyError:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            except Exception:
                # a rendering bug must be loud (the endpoint is how
                # operators see the server) and still answer HTTP
                LOG.warning("metrics endpoint: render failed for %s", path,
                            exc_info=True)
                writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                             b"Content-Length: 0\r\n"
                             b"Connection: close\r\n\r\n")
            else:
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: " + ctype +
                        b"\r\nContent-Length: " + str(len(body)).encode() +
                        b"\r\nConnection: close\r\n\r\n")
                writer.write(head + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        except Exception:
            # e.g. LimitOverrunError/ValueError from an oversized header
            # line: never let a bad scraper leak task exceptions
            LOG.debug("metrics endpoint: bad request", exc_info=True)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
