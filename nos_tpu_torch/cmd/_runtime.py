"""The process runtime shared by the mains, ``nos_tpu/cmd/_runtime.py``
for the port (the controller-runtime manager every reference main
starts, cmd/gpupartitioner/gpupartitioner.go:72-268): named run loops on
threads, graceful SIGINT/SIGTERM shutdown, and an HTTP endpoint serving
``/healthz`` and ``/readyz`` (operator.go:112-119), ``/metrics`` (the
Prometheus text of ``exporter/metrics.py``'s registry) and
``/debug/flightrecorder`` (``obs.flight_snapshot``), ``/debug/slo``
(the SLO engine's report; 404 with none installed) and, with an API
attached, ``/snapshot``: the cluster's state, the metric series, the
chip-second ledger's waste report and, with an engine, its report.
``Main.attach_slo`` installs an engine and samples it on a run loop.
"""

from __future__ import annotations

import http.server
import json
import logging
import signal
import threading
import time
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_runloop_errors_total",
                  "Reconcile ticks that raised (survived, logged)")
REGISTRY.describe("nos_tpu_runloop_tick_seconds",
                  "Run-loop tick duration (count/sum/max per loop)")


class RunLoop(threading.Thread):
    """``fn()`` every ``interval_s`` until ``stop``.  A tick that raises
    is logged and counted, not fatal (level-triggered reconcile)."""

    def __init__(self, name: str, fn: Callable[[], object],
                 interval_s: float, stop: threading.Event,
                 gate: threading.Event | None = None) -> None:
        super().__init__(name=name, daemon=True)
        self._fn = fn
        self._interval = interval_s
        # not ``_stop``: threading.Thread uses that name
        self._halt = stop
        self._gate = gate        # tick only while set (leader election)

    def set_gate(self, gate: threading.Event | None) -> None:
        self._gate = gate

    def run(self) -> None:
        while not self._halt.is_set():
            if self._gate is not None and not self._gate.is_set():
                self._halt.wait(0.2)
                continue
            t0 = time.perf_counter()
            try:
                self._fn()
            except Exception:  # noqa: BLE001 — reconcile loops survive
                logger.exception("run loop %s: tick failed", self.name)
                REGISTRY.inc("nos_tpu_runloop_errors_total",
                             labels={"loop": self.name})
            tick = time.perf_counter() - t0
            REGISTRY.observe("nos_tpu_runloop_tick_seconds", tick,
                             labels={"loop": self.name})
            # a fixed period: the tick's own time counts against the
            # interval, so a slow tick does not stretch the period
            self._halt.wait(max(0.0, self._interval - tick))


class _HealthHandler(http.server.BaseHTTPRequestHandler):
    main: "Main" = None  # type: ignore[assignment]

    def do_GET(self):  # noqa: N802 — stdlib API
        if self.path == "/healthz":
            self._respond(200, "ok")
        elif self.path == "/readyz":
            ready = self.main is not None and self.main.ready.is_set()
            self._respond(200 if ready else 503,
                          "ok" if ready else "not ready")
        elif self.path == "/metrics":
            self._respond(200, REGISTRY.render(),
                          content_type="text/plain; version=0.0.4")
        elif self.path == "/debug/flightrecorder":
            from nos_tpu_torch.obs import flight_snapshot

            self._respond(200, json.dumps(flight_snapshot()),
                          content_type="application/json")
        elif self.path == "/debug/slo":
            from nos_tpu_torch.obs.slo import get_engine

            engine = get_engine()
            if engine is None:
                self._respond(404, "no SLO engine installed "
                                   "(Main.attach_slo)")
                return
            self._respond(200, json.dumps(engine.report()),
                          content_type="application/json")
        elif self.path == "/snapshot":
            # what the one-shot metrics exporter reads, and `obs top`
            if self.main is None or self.main.api is None:
                self._respond(404, "no api server attached")
                return
            from nos_tpu_torch.kube.serialize import dump_state
            from nos_tpu_torch.obs.ledger import get_ledger
            from nos_tpu_torch.obs.slo import get_engine

            payload = {"state": dump_state(self.main.api),
                       "metrics": REGISTRY.snapshot(),
                       "waste": get_ledger().report()}
            engine = get_engine()
            if engine is not None:
                payload["slo"] = engine.report()
            self._respond(200, json.dumps(payload),
                          content_type="application/json")
        else:
            self._respond(404, "not found")

    def _respond(self, code: int, body: str,
                 content_type: str = "text/plain") -> None:
        data = body.encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            # the scraper hung up mid-response: not a server error
            logger.debug("health endpoint: client disconnected mid-write")

    def log_message(self, *args) -> None:  # quiet
        pass


class Main:
    """Owns the stop event, the run-loop threads and the health server."""

    def __init__(self, name: str, health_addr: str = "",
                 api=None) -> None:
        self.name = name
        self.stop = threading.Event()
        self.ready = threading.Event()
        self.api = api            # the API behind /snapshot (optional)
        self._loops: list[RunLoop] = []
        self._server: http.server.ThreadingHTTPServer | None = None
        self._health_addr = health_addr
        self._elector = None
        self._elector_thread: threading.Thread | None = None
        # the elector's own stop, set by shutdown() once the loops are
        # joined: the lease is released only after the last tick
        self._elector_stop = threading.Event()
        self._leader_gate: threading.Event | None = None
        self._loops_lock = threading.Lock()
        self._started = False
        self._shutdown_hooks: list[Callable[[], None]] = []

    def add_shutdown_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` during shutdown()."""
        self._shutdown_hooks.append(fn)

    def add_loop(self, name: str, fn: Callable[[], object],
                 interval_s: float) -> None:
        """Thread-safe at any point: a loop added after start() (e.g.
        controllers bound on winning the lease) starts at once."""
        loop = RunLoop(name, fn, interval_s, self.stop,
                       gate=self._leader_gate)
        with self._loops_lock:
            self._loops.append(loop)
            if self._started:
                loop.start()

    def attach_slo(self, engine=None, interval_s: float = 1.0) -> None:
        """Install an SLO engine (``obs/slo.py``) as the process's and
        add its tick as a run loop: every ``interval_s`` the sampler
        takes the registry and the engine judges every objective.
        Without ``engine``, one over the default objectives."""
        from nos_tpu_torch.obs.slo import (
            SLOEngine, default_objectives, set_engine,
        )
        from nos_tpu_torch.obs.timeseries import TimeSeriesSampler

        if engine is None:
            engine = SLOEngine(TimeSeriesSampler(), default_objectives())
        set_engine(engine)
        self.add_loop("slo-sampler", engine.tick, interval_s)

    def attach_leader_election(self, elector) -> None:
        """Gate every run loop (added before or after) on holding the
        lease (``kube/leaderelection.py``); the elector's loop
        (``elector.run(stop)``) starts with the main.  Losing an acquired
        lease stops the main: watch-bound controllers cannot be unbound,
        so a demoted process exits and rejoins as a candidate.
        ``shutdown`` stops the elector after the run loops and waits for
        it, so the lease is released before the process exits and after
        its last tick (the JAX package's ``Main`` stops both at once and
        does not wait)."""
        self._elector = elector
        self._leader_gate = elector.is_leader
        if elector.on_stopped_leading is None:
            elector.on_stopped_leading = self.stop.set
        for loop in self._loops:
            loop.set_gate(self._leader_gate)

    def start(self) -> None:
        if self._health_addr:
            host, port = self._health_addr.rsplit(":", 1)
            handler = type("Handler", (_HealthHandler,), {"main": self})
            self._server = http.server.ThreadingHTTPServer(
                (host or "127.0.0.1", int(port)), handler)
            threading.Thread(target=self._server.serve_forever,
                             name=f"{self.name}-health",
                             daemon=True).start()
            logger.info("%s: health/metrics on %s", self.name,
                        self.health_address)
        if self._elector is not None:
            self._elector_thread = threading.Thread(
                target=self._elector.run, args=(self._elector_stop,),
                name=f"{self.name}-leader-election", daemon=True)
            self._elector_thread.start()
        with self._loops_lock:
            self._started = True
            for loop in self._loops:
                if not loop.is_alive():
                    loop.start()
        self.ready.set()
        logger.info("%s: %d run loop(s) started", self.name,
                    len(self._loops))

    @property
    def health_address(self) -> str:
        """The bound host:port (a ``:0`` config port resolved)."""
        if self._server is None:
            return ""
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def shutdown(self) -> None:
        self.stop.set()
        self.ready.clear()
        with self._loops_lock:
            loops = list(self._loops)
        for loop in loops:
            loop.join(timeout=5.0)
        self._elector_stop.set()
        if self._elector_thread is not None:
            self._elector_thread.join(timeout=5.0)
        for hook in self._shutdown_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("%s: shutdown hook failed", self.name)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        logger.info("%s: shut down", self.name)

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: self.stop.set())

    def run_until_stopped(self) -> None:
        """start(), block until a signal (or ``stop``) arrives, then shut
        down gracefully (the ``mgr.Start(ctx)`` analog)."""
        self.install_signal_handlers()
        self.start()
        try:
            while not self.stop.is_set():
                self.stop.wait(0.2)
        finally:
            self.shutdown()


def health_port(addr: str) -> int:
    return int(addr.rsplit(":", 1)[1]) if addr else 0


def build_api(cfg):
    """The substrate a main runs against: a cluster's kube-apiserver
    when the config names a kubeconfig, the in-memory APIServer
    otherwise."""
    if getattr(cfg, "kubeconfig", ""):
        from nos_tpu_torch.kube.rest import KubeClient

        logger.info("substrate: kube-apiserver via %s", cfg.kubeconfig)
        return KubeClient.from_kubeconfig(cfg.kubeconfig)
    from nos_tpu_torch.kube.client import APIServer

    return APIServer()
