"""Live scrape endpoint over a capture directory: ``watch --serve``.

Counterpart of ``pta_replicator_tpu/obs/serve.py``, with its routes and
verdicts. The flight recorder rewrites a capture's live files atomically
every tick; this module serves them over standard-library HTTP:

* ``/metrics``: the Prometheus text (``metrics.prom``);
* ``/progress``: the current heartbeat (also ``/progress.json``);
* ``/series``: the recent series windows and span percentiles;
* ``/healthz``: liveness, 200 while the heartbeat is fresh, 503 on no
  heartbeat, a stale one, or a postmortem;
* ``/readyz``: ``/healthz`` plus the SLO verdict (503 "slo-breach" while
  an objective's fast burn is past its threshold) and the numerics
  verdict (503 "numerics" while a probe site has an open non-finite
  episode);
* ``/slo``, ``/numerics``, ``/postmortem``: ``slo.json``,
  ``numerics.json``, ``postmortem.json``;
* ``/critpath``: ``critpath.json``, the attribution ``critpath DIR``
  writes (404 before it is written, as any missing file);
* ``/``: a JSON index.

Read-only: GET and HEAD only, every route a fixed file name inside the
served directory (no path from the URL reaches the file system), bound to
loopback by default. A read racing the sampler sees the old or the new
document, never a splice, because every served file is replaced by
rename.
"""
from __future__ import annotations

import http.server
import json
import os
import threading
import time
from typing import Tuple

#: route -> (filename inside the capture dir, content type). The URL
#: path is looked up here verbatim — there is no path traversal surface.
ROUTES = {
    "/metrics": ("metrics.prom", "text/plain; version=0.0.4"),
    "/progress": ("progress.json", "application/json"),
    "/progress.json": ("progress.json", "application/json"),
    "/series": ("series.json", "application/json"),
    "/series.json": ("series.json", "application/json"),
    "/postmortem": ("postmortem.json", "application/json"),
    "/postmortem.json": ("postmortem.json", "application/json"),
    "/slo": ("slo.json", "application/json"),
    "/slo.json": ("slo.json", "application/json"),
    "/critpath": ("critpath.json", "application/json"),
    "/critpath.json": ("critpath.json", "application/json"),
    "/numerics": ("numerics.json", "application/json"),
    "/numerics.json": ("numerics.json", "application/json"),
}


class _Handler(http.server.BaseHTTPRequestHandler):
    # the server is an observer: it must never block the run or spam
    # its stderr with access logs
    def log_message(self, fmt, *args):  # noqa: D102 — silence stdlib log
        pass

    def _respond(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _healthz(self, readiness: bool = False) -> None:
        """Health verdict from the capture artifacts: 200 while the
        heartbeat is fresh, 503 otherwise — truthful for a run that
        never started a flight recorder (no heartbeat = not ready) and
        for one that died (postmortem = not healthy).

        ``readiness`` (the /readyz route) additionally folds in the
        active SLO verdict from ``slo.json``: a live run whose
        fast-window burn rate breached goes 503 "slo-breach" — alive,
        but a load balancer should stop sending it traffic until the
        burn subsides. /healthz stays pure liveness (a breaching
        server must NOT be restarted by a liveness probe)."""
        directory = self.server.directory
        doc = {"ok": False}
        if os.path.exists(os.path.join(directory, "postmortem.json")):
            doc["state"] = "postmortem"
        else:
            try:
                mtime = os.path.getmtime(
                    os.path.join(directory, "progress.json")
                )
            except OSError:
                doc["state"] = "no-heartbeat"
            else:
                # heartbeat mtimes are wall clock; nothing monotonic
                # can be compared against them
                age = time.time() - mtime  # an mtime is wall clock
                doc["heartbeat_age_s"] = round(age, 3)
                if age <= self.server.stale_after_s:
                    doc.update(ok=True, state="live")
                else:
                    doc["state"] = "stale"
        if readiness and doc["ok"]:
            breached = self._slo_breach()
            if breached:
                doc.update(ok=False, state="slo-breach",
                           breached=breached)
        if readiness and doc["ok"]:
            episodes = self._numerics_episodes()
            if episodes:
                doc.update(ok=False, state="numerics",
                           nonfinite_sites=episodes)
        self._respond(
            200 if doc["ok"] else 503,
            json.dumps(doc).encode(), "application/json",
        )

    def _slo_breach(self) -> list:
        """Breached objective names from the live slo.json (empty when
        no SLO is configured, the file is absent, or it is torn — a
        readiness probe must degrade to the liveness verdict, never
        503 a healthy run on a parse error)."""
        from .slo import any_breach

        try:
            with open(os.path.join(self.server.directory, "slo.json"),
                      "rb") as fh:
                return any_breach(json.loads(fh.read()))
        except (OSError, json.JSONDecodeError):
            return []

    def _numerics_episodes(self) -> list:
        """Probe sites with an OPEN non-finite episode from the live
        numerics.json (empty when the observatory never armed, the file
        is absent, or it is torn — the same degrade-to-liveness
        contract as the SLO rung). The episode clears — and /readyz
        re-arms — after the site's configured clean streak
        (obs/numerics.py EPISODE_CLEAR_AFTER)."""
        try:
            with open(os.path.join(self.server.directory,
                                   "numerics.json"), "rb") as fh:
                doc = json.loads(fh.read())
            return list(doc.get("episodes_active") or [])
        except (OSError, json.JSONDecodeError):
            return []

    def do_GET(self) -> None:  # noqa: N802 — stdlib handler contract
        path = self.path.split("?", 1)[0]
        if path in ("/", "/index.json"):
            body = json.dumps({
                "directory": self.server.directory,
                "endpoints": sorted(
                    set(ROUTES) | {"/healthz", "/readyz"}
                ),
            }, indent=1).encode()
            self._respond(200, body, "application/json")
            return
        if path in ("/healthz", "/readyz"):
            self._healthz(readiness=(path == "/readyz"))
            return
        route = ROUTES.get(path)
        if route is None:
            self._respond(404, json.dumps({
                "error": f"unknown endpoint {path!r}",
                "endpoints": sorted(
                    set(ROUTES) | {"/healthz", "/readyz"}
                ),
            }).encode(), "application/json")
            return
        fname, ctype = route
        try:
            # one open+read of an atomic-replace artifact: a concurrent
            # sampler tick swaps the inode, the open handle keeps the
            # consistent old document (POSIX rename semantics)
            with open(os.path.join(self.server.directory, fname),
                      "rb") as fh:
                body = fh.read()
        except OSError:
            self._respond(404, json.dumps({
                "error": f"{fname} not written yet (run not started, "
                         "or started without a flight recorder)",
            }).encode(), "application/json")
            return
        self._respond(200, body, ctype)

    def do_HEAD(self) -> None:  # noqa: N802
        self.do_GET()


class TelemetryServer(http.server.ThreadingHTTPServer):
    """Threaded HTTP server bound to one capture directory."""

    daemon_threads = True

    def __init__(self, directory: str, address: Tuple[str, int],
                 stale_after_s: float = 150.0):
        self.directory = os.path.abspath(directory)
        #: /healthz freshness bound: the flight recorder's sampler
        #: self-stretches its interval up to 30 s under load, so the
        #: default leaves a generous 5x margin before declaring stale
        self.stale_after_s = float(stale_after_s)
        super().__init__(address, _Handler)


def serve_directory(
    directory: str,
    port: int,
    host: str = "127.0.0.1",
    background: bool = False,
) -> TelemetryServer:
    """Serve ``directory``'s live telemetry artifacts on ``host:port``.

    ``background=True`` (the ``watch --serve`` path: the foreground
    keeps tailing the heartbeat) runs ``serve_forever`` on a daemon
    thread and returns immediately; otherwise the caller drives the
    server (``serve_forever``/``shutdown``). Port 0 binds an ephemeral
    port — read it back from ``server.server_address``."""
    server = TelemetryServer(directory, (host, int(port)))
    if background:
        threading.Thread(
            target=server.serve_forever, name="obs-serve", daemon=True
        ).start()
    return server


def serve_url(server: TelemetryServer, route: str = "/") -> str:
    host, port = server.server_address[:2]
    return f"http://{host}:{port}{route}"
