"""HeartbeatServer (§3.1): per-node resource monitor on its own port, a copy of
``repro.core.heartbeat`` (``telemetry``, ``HeartbeatServer``, ``check_heartbeat``).

A successful heartbeat response proves the *system* is up; the application
answering on its own port proves the *application* is up. ``HeartbeatServer``
is a stdlib HTTP server on localhost, on a thread of its own.

The device report is the port's own: the CUDA card through torch
(``{"backend": "cuda", "count": n}``) once this process has initialized
CUDA, else ``"uninitialized"``, as the reference reports JAX's devices only
once JAX is imported. The asyncio probe is not copied.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

__all__ = ["telemetry", "HeartbeatServer", "check_heartbeat"]

_START = time.monotonic()  # uptime is interval math: immune to clock steps


def _meminfo() -> Dict[str, float]:
    total = avail = 0.0
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1]) * 1024
    except OSError:
        pass
    return {
        "total_bytes": total,
        "available_bytes": avail,
        "used_frac": (1.0 - avail / total) if total else 0.0,
    }


def telemetry(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JSON resource report of §3.1: CPU/disk/memory/devices + liveness."""
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:  # pragma: no cover
        load1 = load5 = load15 = 0.0
    ncpu = os.cpu_count() or 1
    disk = shutil.disk_usage("/")
    report: Dict[str, Any] = {
        "ok": True,
        "time": time.time(),  # record timestamp: wall clock is correct here
        "uptime_s": time.monotonic() - _START,
        "cpu": {
            "load1": load1,
            "load5": load5,
            "load15": load15,
            "ncpu": ncpu,
            "used_frac": min(1.0, load1 / ncpu),
        },
        "memory": _meminfo(),
        "disk": {
            "total_bytes": disk.total,
            "free_bytes": disk.free,
            "used_frac": 1.0 - disk.free / disk.total,
        },
        "devices": _device_report(),
        "pid": os.getpid(),
    }
    if extra:
        report.update(extra)
    return report


def _device_report() -> Dict[str, Any]:
    """The card, as torch sees it; never initializes CUDA from the heartbeat thread."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"backend": "uninitialized", "count": 0}
    try:
        return {"backend": "cuda", "count": torch.cuda.device_count()}
    except Exception:  # pragma: no cover
        return {"backend": "error", "count": 0}


class _Handler(BaseHTTPRequestHandler):
    server_version = "SerPyTorHeartbeat/1.0"

    def do_GET(self) -> None:  # noqa: N802
        if self.path.rstrip("/") in ("", "/heartbeat", "/health"):
            body = json.dumps(telemetry(self.server.extra)).encode()  # type: ignore[attr-defined]
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, *args) -> None:  # silence
        pass


class HeartbeatServer:
    """Separate-port heartbeat endpoint (assumption 1 of §3.2)."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        extra: Optional[Dict[str, Any]] = None,
    ):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.extra = extra or {}  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"heartbeat:{self.port}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "HeartbeatServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def check_heartbeat(address: str, timeout: float = 1.0) -> Optional[Dict[str, Any]]:
    """Poll a heartbeat endpoint. None ⇒ system-level failure (§3.2).

    A successful probe is stamped with ``probe_latency_s`` (round-trip time
    as seen by the caller) so the gateway's cached telemetry carries a
    network-health signal alongside the worker's self-report. The RTT is
    measured on the monotonic clock — a wall-clock step mid-probe (NTP
    correction, manual adjustment) must not poison the latency signal.
    """
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(
            address.rstrip("/") + "/heartbeat", timeout=timeout
        ) as resp:
            report = json.loads(resp.read())
        report["probe_latency_s"] = time.monotonic() - t0
        return report
    except Exception:
        return None
