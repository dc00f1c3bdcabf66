"""Live ops plane: in-process introspection server (stdlib only).

Port of ``deepspeed_tpu/telemetry/ops_plane.py``: the same endpoints and
JSON keys, so a probe or dashboard written for the reference reads the
port. The metrics registry, the request event ring, the HealthMonitor,
the cost cards and goodput ledger become an operable surface: set
``DS_TPU_OPS_PORT`` and a daemon-threaded ``http.server`` exposes the live
engine, read-only, zero dependencies:

====================  =====================================================
``GET /metrics``      Prometheus text exposition (the existing exporter)
``GET /healthz``      HealthMonitor status + latched alerts; **503** when
                      unhealthy, so it plugs into any probe/LB unchanged
``GET /requests``     recent request timelines summarised (state, latency
                      split) via ``request_timelines``/``request_metrics``
``GET /requests/<uid>``  every recorded timeline for one uid
``GET /perf``         PerfAccountant snapshot: cost cards, roofline,
                      goodput ledger, HBM pools
``GET /journal``      the serving journal's state and record tail
``GET /flight``       flight-capture ring listing; ``/flight/<name>``
                      fetches one manifest
``POST /flight/capture``  manual black-box capture (optional JSON body
                      ``{"reason": ...}``)
``GET /profile``      device-timeline profiler status + last per-quantum
                      waterfall summary (telemetry/profiler.py)
``POST /profile/capture``  arm a one-shot device-timeline capture
                      (optional JSON body ``{"quanta": N}``)
``GET /varz``         resolved knob registry from ``analysis/knobs.py``
====================  =====================================================

Every JSON payload is rank-stamped and bounded (``MAX_BODY_BYTES``, plus
hard caps on list lengths) so a scrape can never ship an unbounded ring.
With the port knob unset nothing happens: no thread, no socket.
"""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..analysis import knobs

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 2 << 20   # hard ceiling on any single response body
MAX_REQUESTS = 128         # /requests: most-recent request summaries
MAX_TIMELINE_EVENTS = 2048  # /requests/<uid>: events across its timelines

_ENDPOINTS = ("/metrics", "/healthz", "/requests", "/requests/<uid>",
              "/perf", "/journal", "/flight", "/flight/<name>",
              "/flight/capture (POST)", "/profile",
              "/profile/capture (POST)", "/varz")


def _json_body(payload, status: int = 200) -> Tuple[int, str, bytes]:
    body = json.dumps(payload, indent=2, sort_keys=True, default=str).encode()
    if len(body) > MAX_BODY_BYTES:
        body = json.dumps({"error": "payload too large",
                           "bytes": len(body)}).encode()
        status = 500
    return status, "application/json", body


class OpsPlane:
    """Route handlers, separable from the HTTP plumbing for direct-call
    tests. All handlers are read-only views over the process-wide
    telemetry singletons (except the explicit ``POST /flight/capture``)."""

    def handle(self, method: str, path: str,
               body: bytes = b"") -> Tuple[int, str, bytes]:
        path = path.split("?", 1)[0].rstrip("/") or "/"
        if method == "POST":
            if path == "/flight/capture":
                return self._flight_capture(body)
            if path == "/profile/capture":
                return self._profile_capture(body)
            return _json_body({"error": "method not allowed"}, 405)
        if path == "/":
            return _json_body({"service": "deepspeed_tpu_torch ops plane",
                               "endpoints": list(_ENDPOINTS)})
        if path == "/metrics":
            return self._metrics()
        if path == "/healthz":
            return self._healthz()
        if path == "/requests":
            return self._requests()
        if path.startswith("/requests/"):
            return self._request_detail(path[len("/requests/"):])
        if path == "/perf":
            return self._perf()
        if path == "/journal":
            return self._journal()
        if path == "/varz":
            return self._varz()
        if path == "/profile":
            return self._profile()
        if path == "/flight":
            return self._flight_list()
        if path.startswith("/flight/"):
            return self._flight_detail(path[len("/flight/"):])
        return _json_body({"error": f"unknown endpoint {path!r}",
                           "endpoints": list(_ENDPOINTS)}, 404)

    # ------------------------------------------------------------ routes
    def _metrics(self) -> Tuple[int, str, bytes]:
        from .registry import get_registry
        body = get_registry().render_prometheus().encode()
        return 200, "text/plain; version=0.0.4", body

    def _healthz(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .health import get_health_monitor
        mon = get_health_monitor()
        healthy = mon.healthy
        payload = {
            "status": "ok" if healthy else "alerting",
            "healthy": healthy,
            "rank": rank_stamp(),
            "detectors": {name: {"firing": d.firing,
                                 "severity": d.severity}
                          for name, d in sorted(mon._detectors.items())},
            "alerts": [a.as_dict() for a in mon.alerts()],
        }
        return _json_body(payload, 200 if healthy else 503)

    def _requests(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .events import (get_event_log, latency_summary, request_metrics,
                             request_timelines)
        events = get_event_log().events()
        rows = []
        for uid, tls in request_timelines(events).items():
            tl = tls[-1]
            row = {"uid": uid, "timelines": len(tls),
                   "state": tl[-1]["kind"], "last_ts": tl[-1]["ts"],
                   "n_events": len(tl)}
            m = request_metrics(tl)
            if m is not None:
                row["metrics"] = m
            rows.append(row)
        rows.sort(key=lambda r: r["last_ts"], reverse=True)
        payload = {"rank": rank_stamp(), "n_tracked": len(rows),
                   "truncated": len(rows) > MAX_REQUESTS,
                   "summary": latency_summary(events),
                   "requests": rows[:MAX_REQUESTS]}
        return _json_body(payload)

    def _request_detail(self, raw_uid: str) -> Tuple[int, str, bytes]:
        from .events import get_event_log, request_metrics, request_timelines
        try:
            uid = int(raw_uid)
        except ValueError:
            return _json_body({"error": f"bad uid {raw_uid!r}"}, 400)
        tls = request_timelines(get_event_log().events(uid=uid)).get(uid, [])
        if not tls:
            return _json_body({"error": f"no timeline for uid {uid}"}, 404)
        budget = MAX_TIMELINE_EVENTS
        out_tls = []
        for tl in reversed(tls):  # newest timelines keep their events first
            take = tl[-budget:] if budget > 0 else []
            budget -= len(take)
            out_tls.append({"events": take, "metrics": request_metrics(tl)})
        out_tls.reverse()
        return _json_body({"uid": uid, "timelines": out_tls})

    def _perf(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .costs import get_perf_accountant
        payload = get_perf_accountant().snapshot()
        payload["rank"] = rank_stamp()
        return _json_body(payload)

    def _journal(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .journal import get_journal
        journal = get_journal()
        payload = ({"enabled": False} if journal is None
                   else journal.manifest_section())
        payload["rank"] = rank_stamp()
        return _json_body(payload)

    def _varz(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .flight import knob_provenance, resolved_knobs, tuned_profile_section
        return _json_body({"rank": rank_stamp(), "knobs": resolved_knobs(),
                           "knob_provenance": knob_provenance(),
                           "tuned_profile": tuned_profile_section()})

    def _flight_list(self) -> Tuple[int, str, bytes]:
        from .flight import get_flight_recorder
        rec = get_flight_recorder()
        if rec is None:
            return _json_body({"configured": False, "captures": []})
        return _json_body({"configured": True, "flight_dir": rec.flight_dir,
                           "max_captures": rec.max_captures,
                           "captures": rec.captures()})

    def _flight_detail(self, name: str) -> Tuple[int, str, bytes]:
        from .flight import get_flight_recorder
        rec = get_flight_recorder()
        manifest = rec.read_manifest(name) if rec is not None else None
        if manifest is None:
            return _json_body({"error": f"no capture {name!r}"}, 404)
        return _json_body(manifest)

    def _profile(self) -> Tuple[int, str, bytes]:
        from .agg import rank_stamp
        from .profiler import get_device_profiler
        prof = get_device_profiler()
        if prof is None:
            return _json_body({"configured": False, "rank": rank_stamp()})
        payload = {"configured": True, "rank": rank_stamp(),
                   **prof.status()}
        summary = prof.summary()
        if summary is not None:
            # the stored summary is already bounded (MAX_QUANTA_ROWS,
            # top-N programs); _json_body enforces the byte ceiling
            payload["summary"] = summary
        return _json_body(payload)

    def _profile_capture(self, body: bytes) -> Tuple[int, str, bytes]:
        from .profiler import request_capture
        quanta = None
        if body:
            try:
                quanta = json.loads(body.decode()).get("quanta")
                quanta = int(quanta) if quanta is not None else None
            except (ValueError, AttributeError, TypeError):
                return _json_body({"error": "bad JSON body"}, 400)
        prof, armed = request_capture(quanta)
        status = prof.status()
        if not armed:
            return _json_body({"error": "capture already tracing",
                               **status}, 409)
        return _json_body({"armed": True, **status}, 201)

    def _flight_capture(self, body: bytes) -> Tuple[int, str, bytes]:
        from .flight import get_flight_recorder
        rec = get_flight_recorder()
        if rec is None:
            return _json_body(
                {"error": "flight recorder not configured "
                          "(set DS_TPU_FLIGHT_DIR)"}, 409)
        reason = "manual"
        if body:
            try:
                reason = str(json.loads(body.decode()).get("reason", reason))
            except (ValueError, AttributeError):
                pass
        path = rec.capture(reason=reason)
        return _json_body({"captured": path}, 201)


class _Handler(BaseHTTPRequestHandler):
    plane: OpsPlane = None  # set by OpsServer on the subclass

    def _respond(self, method: str) -> None:
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, ctype, payload = self.plane.handle(method, self.path, body)
        except Exception as e:  # introspection must never crash serving
            status, ctype, payload = 500, "application/json", json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:
        self._respond("GET")

    def do_POST(self) -> None:
        self._respond("POST")

    def log_message(self, fmt, *args) -> None:
        pass  # scrapes are frequent; stderr noise helps nobody


class OpsServer:
    """Daemon-threaded HTTP server wrapper. ``port=0`` binds an
    ephemeral port (tests); production wiring resolves the port from
    ``DS_TPU_OPS_PORT`` via ``maybe_start_ops_server``."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self.plane = OpsPlane()
        handler = type("OpsHandler", (_Handler,), {"plane": self.plane})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "OpsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="ds-tpu-ops-plane",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout)
            self._thread = None
        self._httpd.server_close()


_SERVER: Optional[OpsServer] = None
_SERVER_LOCK = threading.Lock()


def get_ops_server() -> Optional[OpsServer]:
    return _SERVER


def maybe_start_ops_server() -> Optional[OpsServer]:
    """Start the process-wide introspection server iff ``DS_TPU_OPS_PORT``
    is set to a nonzero port. Idempotent, safe to call from every engine
    constructor; with the knob unset this is one int compare — no thread,
    no socket."""
    global _SERVER
    port = knobs.get_int("DS_TPU_OPS_PORT")
    if port <= 0:
        return None
    if _SERVER is not None:
        return _SERVER
    with _SERVER_LOCK:
        if _SERVER is None:
            try:
                server = OpsServer(port=port).start()
            except OSError as e:  # port taken: degrade, don't kill serving
                logger.warning("ops plane: could not bind port %d: %s", port, e)
                return None
            logger.info("ops plane: serving introspection endpoints on :%d",
                        server.port)
            _SERVER = server
    return _SERVER
