"""Worker liveness leases: heartbeats pumped by the step (counterpart of
kungfu_tpu/elastic/heartbeat.py).

The watcher's reap only sees workers that die.  A worker hung in a
collective, or stopped, keeps its process alive and stalls the group
until the collective's timeout.  Leases close that gap: the trainer
renews a lease on the config server (``POST /heartbeat``) from its step
path, the server serves last-seen ages on ``GET /health``, and the
watcher turns a lease older than its TTL into the same exclusion a
killed worker's death takes.

:meth:`HeartbeatSender.beat` is called from the step path, never from a
timer: a timer would keep renewing the lease of a worker whose step loop
is wedged, the very failure leases expose.  ``beat()`` is a monotonic
check that, at most once per ``interval_s``, hands the payload to a
daemon thread, which does the POST; a slow or dead server costs the step
nothing, and a missed POST is not retried (a missed beat is the signal).
The interval reaches a worker as ``--kf-heartbeat-s``; 0 turns the
sender off.
"""
from __future__ import annotations

import contextlib
import http.client
import json
import socket
import sys
import threading
import time
import urllib.parse
from typing import Optional

from .config_server import health_url


class HeartbeatSender:
    """Lease renewals of ``peer`` (``host:port``) to the config server at
    ``url`` (its ``/config`` URL), at most once per ``interval_s``."""

    def __init__(self, url: str, peer: str, interval_s: float = 2.0):
        self.url = url
        self.peer = peer
        self.interval_s = max(0.1, float(interval_s))
        self.misses = 0
        self.post_timeout_s = 2.0
        self._last = -float("inf")
        self._pending: Optional[dict] = None
        self._deadline: Optional[float] = None
        self._conn: Optional[http.client.HTTPConnection] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"kft-heartbeat-{peer}")
        self._thread.start()

    # ------------------------------------------------------------- step side
    def beat(self, *, rank: Optional[int] = None,
             step: Optional[int] = None,
             version: Optional[int] = None) -> bool:
        """Renew the lease if the interval elapsed; True when a renewal
        was handed to the sender.  A cheap no-op otherwise."""
        now = time.monotonic()
        if now - self._last < self.interval_s:
            return False
        self._last = now
        with self._lock:
            self._pending = {"rank": rank, "step": step, "version": version}
        self._wake.set()
        return True

    # ----------------------------------------------------------- sender side
    def _post(self, payload: dict) -> None:
        """One renewal on a connection the sender owns, so that ``stop()``
        can close an attempt in flight.  One attempt."""
        timeout = self.post_timeout_s
        deadline = self._deadline
        if deadline is not None:
            # stopping: clamp the attempt to the rest of the join budget
            timeout = max(0.05, min(timeout, deadline - time.monotonic()))
        u = urllib.parse.urlsplit(health_url(self.url, "/heartbeat"))
        body = json.dumps({"peer": self.peer, **payload}).encode()
        conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                          timeout=timeout)
        with self._lock:
            self._conn = conn
        try:
            try:
                conn.request("POST", u.path or "/heartbeat", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
            except http.client.HTTPException as e:
                raise OSError(f"heartbeat: {e!r}") from e
            if resp.status >= 400:
                raise OSError(f"heartbeat HTTP {resp.status}")
        finally:
            with self._lock:
                self._conn = None
            conn.close()

    def _run(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            if self._stop:
                return
            with self._lock:
                payload, self._pending = self._pending, None
            if payload is None:
                continue
            try:
                self._post(payload)
            except (OSError, ValueError) as e:
                if self._stop:
                    return  # stop() closed the socket in flight
                # a missed beat is the signal, not an error to fight
                self.misses += 1
                if self.misses in (1, 10, 100):
                    print(f"kft: heartbeat to {self.url} failing ({e!r}); "
                          f"{self.misses} missed", file=sys.stderr,
                          flush=True)

    def stop(self, join_timeout: float = 2.0) -> None:
        """Stop the sender within ``join_timeout`` seconds, closing a POST
        in flight against a dead or wedged server."""
        deadline = time.monotonic() + max(0.0, join_timeout)
        self._deadline = deadline
        self._stop = True
        self._wake.set()
        with self._lock:
            conn = self._conn
        if conn is not None:
            sock = getattr(conn, "sock", None)
            if sock is not None:
                with contextlib.suppress(OSError):
                    sock.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                conn.close()
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))

    @classmethod
    def for_worker(cls, we, interval_s: float
                   ) -> Optional["HeartbeatSender"]:
        """The sender of a launcher-started worker (``we``, a
        :class:`~kungfu_tpu_torch.launcher.env.WorkerEnv`); None when it
        has no config server or ``interval_s`` is 0."""
        if not we.config_server or we.self_spec is None or interval_s <= 0:
            return None
        return cls(we.config_server,
                   f"{we.self_spec.host}:{we.self_spec.port}", interval_s)
