"""The elastic config server, the REST control plane of cluster membership
(counterpart of kungfu_tpu/elastic/config_server.py, cut to the wire
protocol).

- ``GET /config`` -> ``{"version": N, "cluster": {...}, "epoch": E}``; 404
  before the first PUT or after a DELETE, with ``version`` and ``epoch``
  in the body so a client can still fence.
- ``PUT /config`` (or POST) <- cluster JSON: validated (400 when
  malformed), the version goes up by one.  ``If-Match: <version>`` makes
  it a compare-and-swap: 409 with the current ``version`` and ``epoch``
  when the server moved on.
- ``DELETE /config`` clears the config and still bumps the version, so a
  CAS holding a version from before the clear cannot win across it.
- ``POST /heartbeat`` <- ``{"peer", "rank", "step", "version"}``: a
  worker renews its liveness lease (400 without ``peer``); leases not
  renewed for ``LEASE_PRUNE_S`` are dropped at the next renewal.
- ``GET /health`` -> ``{"version", "leases": {peer: {"age_s", "rank",
  "step", "version", "beats"}}, "epoch"}``: the ages the watcher turns
  into exclusions of hung workers.
- ``GET /stop`` shuts the server down.

``epoch`` is 48 random bits drawn when the server starts: a client that
sees it change knows the version counter restarted.  The bodies are
byte for byte those of the JAX server, so either package's client talks
to either server.  A caller in the server's process may also
:meth:`ConfigServer.subscribe` to every change.  Not here: the
write-ahead log, ``/history`` and the client's circuit breaker.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

from ..plan.cluster import Cluster
from ..utils.http import BackgroundHTTPServer

BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 1.0
# a lease this stale belongs to a long-gone worker: pruned at the next
# renewal, so the table holds recent peers only
LEASE_PRUNE_S = 600.0


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.version = 0
        self.cluster: Optional[Cluster] = None
        self.epoch = int.from_bytes(os.urandom(6), "big")
        self.listeners: List[Callable[[int, Optional[Cluster]], None]] = []
        self.leases: Dict[str, dict] = {}

    def record(self, cluster: Optional[Cluster]) -> int:
        """Bump the version, install ``cluster`` (None clears) and tell
        the listeners; the caller holds ``lock``."""
        self.version += 1
        self.cluster = cluster
        for listen in self.listeners:
            listen(self.version, cluster)
        return self.version


def _make_handler(state: _State, server_ref):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes = b""):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/stop"):
                self._send(200, b'{"ok": true}')
                server_ref.shutdown_async()
                return
            if self.path.startswith("/health"):
                self._health()
                return
            with state.lock:
                if state.cluster is None:
                    body = json.dumps({"error": "no config",
                                       "version": state.version,
                                       "epoch": state.epoch}).encode()
                    code = 404
                else:
                    body = json.dumps({
                        "version": state.version,
                        "cluster": json.loads(state.cluster.to_json()),
                        "epoch": state.epoch}).encode()
                    code = 200
            self._send(code, body)

        def _health(self):
            now = time.monotonic()
            with state.lock:
                leases = {
                    peer: {"age_s": round(now - d["mono"], 3),
                           "rank": d.get("rank"), "step": d.get("step"),
                           "version": d.get("version"),
                           "beats": d.get("beats", 0)}
                    for peer, d in state.leases.items()}
                body = json.dumps({"version": state.version,
                                   "leases": leases,
                                   "epoch": state.epoch}).encode()
            self._send(200, body)

        def _heartbeat(self):
            n = int(self.headers.get("Content-Length", "0"))
            try:
                d = json.loads(self.rfile.read(n).decode())
                peer = str(d["peer"])
            except (ValueError, KeyError) as e:
                self._send(400, json.dumps(
                    {"error": f"bad heartbeat: {e}"}).encode())
                return
            now = time.monotonic()
            with state.lock:
                prev = state.leases.get(peer)
                state.leases[peer] = {
                    "mono": now, "rank": d.get("rank"),
                    "step": d.get("step"), "version": d.get("version"),
                    "beats": prev["beats"] + 1 if prev else 1}
                for p in [p for p, lease in state.leases.items()
                          if now - lease["mono"] > LEASE_PRUNE_S]:
                    del state.leases[p]
                body = json.dumps({"ok": True,
                                   "epoch": state.epoch}).encode()
            self._send(200, body)

        def do_POST(self):
            if self.path.startswith("/heartbeat"):
                self._heartbeat()
            else:
                self.do_PUT()

        def do_PUT(self):
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n)
            try:
                c = Cluster.from_json(raw.decode())
                c.validate()
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            expect = self.headers.get("If-Match")
            if expect is not None:
                try:
                    expect = int(expect.strip().strip('"'))
                except ValueError:
                    self._send(400, json.dumps(
                        {"error": f"bad If-Match: {expect!r}"}).encode())
                    return
            with state.lock:
                if expect is not None and expect != state.version:
                    code, body = 409, {"error": "version conflict",
                                       "version": state.version,
                                       "epoch": state.epoch}
                else:
                    code, body = 200, {"version": state.record(c),
                                       "epoch": state.epoch}
            self._send(code, json.dumps(body).encode())

        def do_DELETE(self):
            with state.lock:
                state.record(None)
            self._send(200, b'{"ok": true}')

    return Handler


class ConfigServer:
    """The config server on a background thread (``port=0``: the OS picks
    a free port, read back from :attr:`port` / :attr:`url`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._state = _State()
        self._server = BackgroundHTTPServer(
            lambda srv: _make_handler(self._state, srv), host, port)

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def url(self) -> str:
        return f"http://{self._server.host}:{self._server.port}/config"

    @property
    def epoch(self) -> int:
        return self._state.epoch

    def start(self) -> "ConfigServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()

    def put_cluster(self, cluster: Cluster) -> int:
        """An in-process PUT."""
        cluster.validate()
        with self._state.lock:
            return self._state.record(cluster)

    def get_cluster(self) -> Tuple[int, Optional[Cluster]]:
        with self._state.lock:
            return self._state.version, self._state.cluster

    def subscribe(self, listen: Callable[[int, Optional[Cluster]], None]
                  ) -> Tuple[int, Optional[Cluster], Callable[[], None]]:
        """Call ``listen(version, cluster)`` at every later change, in
        order, under the server's lock (so it must not block), for a
        caller in this process that must see every version (the watcher:
        a poll can miss one).  Returns the current version and cluster
        and a function that ends the subscription."""
        with self._state.lock:
            self._state.listeners.append(listen)
            now = self._state.version, self._state.cluster

        def end() -> None:
            with self._state.lock:
                self._state.listeners.remove(listen)
        return (*now, end)


def _call(url: str, parse: Callable[[bytes], object], *, method="GET",
          body: Optional[bytes] = None, headers=None, timeout: float = 5.0,
          deadline: Optional[float] = None, retry_unseeded: bool = False):
    """One HTTP call under a retry loop: ``deadline=None`` makes exactly
    one attempt; a number is the budget in seconds across attempts, with
    jittered exponential backoff between them.  Retried: refused or
    broken connections, 5xx, a body ``parse`` rejects, and 404 when
    ``retry_unseeded``.  Other HTTP errors (400, 409) are answers and are
    raised at once.  When the budget runs out the last error is raised."""
    t_end = None if deadline is None else time.monotonic() + deadline
    attempt = 0
    while True:
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return parse(r.read())
        except urllib.error.HTTPError as e:
            if e.code < 500 and not (e.code == 404 and retry_unseeded):
                raise
            last = e
        except (ValueError, KeyError, OSError) as e:
            last = e
        if t_end is None or time.monotonic() >= t_end:
            raise last
        pause = random.uniform(0.0, min(BACKOFF_CAP_S,
                                        BACKOFF_BASE_S * 2 ** attempt))
        time.sleep(min(pause, max(0.0, t_end - time.monotonic())))
        attempt += 1


def fetch_config(url: str, timeout: float = 5.0,
                 deadline: Optional[float] = None,
                 retry_unseeded: bool = False) -> Tuple[int, Cluster]:
    """GET the current ``(version, cluster)``.  ``timeout`` bounds each
    attempt; ``deadline`` (None: one attempt) and ``retry_unseeded`` as
    in :func:`_call`."""
    def parse(raw: bytes) -> Tuple[int, Cluster]:
        d = json.loads(raw.decode())
        return d["version"], Cluster.from_json(json.dumps(d["cluster"]))

    return _call(url, parse, timeout=timeout, deadline=deadline,
                 retry_unseeded=retry_unseeded)


def put_config(url: str, cluster: Cluster, timeout: float = 5.0,
               if_version: Optional[int] = None,
               deadline: Optional[float] = None) -> int:
    """PUT a cluster and return the new version.  ``if_version`` makes it
    a compare-and-swap: the server answers 409 (an
    ``urllib.error.HTTPError``, never retried) when its version moved
    since that fetch; refetch before trying again."""
    headers = {} if if_version is None else {"If-Match": str(if_version)}
    return _call(url, lambda raw: json.loads(raw.decode())["version"],
                 method="PUT", body=cluster.to_json().encode(),
                 headers=headers, timeout=timeout, deadline=deadline)


def health_url(url: str, path: str) -> str:
    """A sibling endpoint (``/health``, ``/heartbeat``) of the server whose
    ``/config`` URL is ``url``."""
    if url.endswith("/config"):
        return url[: -len("/config")] + path
    return url.rstrip("/") + path


def fetch_health(url: str, timeout: float = 2.0) -> dict:
    """GET the lease table from the server's ``/health`` (``url`` may be
    its ``/config`` URL): ``{"version", "leases": {peer: {"age_s", ...}},
    "epoch"}``.  One attempt."""
    return _call(health_url(url, "/health"),
                 lambda raw: json.loads(raw.decode()), timeout=timeout)
