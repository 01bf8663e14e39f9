"""HTTP front end for the continuous-batching engine (counterpart of
kungfu_tpu/serving/server.py).

A stdlib HTTP server whose handlers enqueue requests, and one scheduler
thread that owns the engine: requests arriving at different times join
the same decode batch, and callers block only on their own completion.

    from kungfu_tpu_torch.serving import DecodeEngine, ServingServer
    srv = ServingServer(engine, port=8100).start()
    # POST /generate  {"prompt": [1,2,3], "max_new": 16,
    #                  "temperature": 0.8, "eos": 50256, "stream": false}
    #   -> {"uid": N, "tokens": [...]}  (ndjson chunks when streaming)
    # GET  /stats -> engine stats + queue depth
    # GET  /requests?n=64 -> the request journal: open and recently
    #                        finished lifecycles + the SLO evaluation
    srv.close()

The engine is single-threaded by construction (device state, block
tables); handlers hand it work through a submission list and per-uid
events.  Under tensor parallelism the server runs on rank 0 only, over
the driver's engine; ``close()`` stops the other ranks.  /stats reads
the pure-Python stat counters directly (a snapshot that may be torn
across fields).  A scheduler death or close() releases
every waiting client with a 503 instead of a wedge.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from ..utils.http import BackgroundHTTPServer
from .engine import DecodeEngine, Request

_STREAM_END = object()


class ServingServer:
    """Wrap a :class:`DecodeEngine` in an HTTP service.

    ``start()`` spawns the HTTP listener and the scheduler thread;
    ``close()`` stops both (releasing any waiting clients with 503).
    """

    def __init__(self, engine: DecodeEngine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self._lock = threading.Lock()        # submissions + results
        self._pending: List[Request] = []
        self._done: Dict[int, List[int]] = {}
        self._events: Dict[int, threading.Event] = {}
        self._streams: Dict[int, "queue.Queue"] = {}
        self._next_uid = 1
        # scheduler-thread-only callback: fan tokens out to stream
        # queues, chaining any callback already installed on the engine
        self._chained_on_tokens = engine.on_tokens
        engine.on_tokens = self._on_tokens
        self._fatal: Optional[str] = None
        self.close_error: Optional[str] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._sched: Optional[threading.Thread] = None
        self._http = BackgroundHTTPServer(self._handler_factory, host,
                                          port)
        self.host, self.port = self._http.host, self._http.port

    def _handler_factory(self, _srv):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer is an HTTP/1.1 construct; non-stream
            # replies all send Content-Length, so keep-alive stays correct
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):            # quiet
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    with server._lock:
                        depth = len(server._pending)
                    s = dict(server.engine.stats.summary(),
                             pending=depth,
                             busy=server.engine.busy)
                    self._reply(200, s)
                elif self.path.startswith("/requests"):
                    # ?n= caps the finished tail (a bad value falls back)
                    qs = parse_qs(urlsplit(self.path).query)
                    try:
                        n = int(qs.get("n", ["64"])[0])
                    except ValueError:
                        n = 64
                    self._reply(200, server.engine.journal.snapshot(n))
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/generate":
                    self._reply(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    prompt = [int(t) for t in req["prompt"]]
                    max_new = int(req["max_new"])
                    eos = req.get("eos")
                    eos = None if eos is None else int(eos)
                    temp = float(req.get("temperature", 0.0))
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                stream = bool(req.get("stream", False))
                try:
                    uid, ev = server._submit(prompt, max_new, eos, temp,
                                             stream=stream)
                except ValueError as e:
                    self._reply(422, {"error": str(e)})
                    return
                except RuntimeError as e:         # already closed/dead
                    self._reply(503, {"error": str(e)})
                    return
                if stream:
                    self._stream_reply(uid)
                    return
                ev.wait()
                with server._lock:
                    tokens = server._done.pop(uid, None)
                    server._events.pop(uid, None)
                    fatal = server._fatal
                if tokens is None:
                    self._reply(503, {"error": fatal or
                                      "server closed before completion"})
                else:
                    self._reply(200, {"uid": uid, "tokens": tokens})

            def _chunk(self, payload: bytes):
                self.wfile.write(f"{len(payload):x}\r\n".encode()
                                 + payload + b"\r\n")

            def _stream_reply(self, uid):
                """Chunked transfer: one JSON line per token batch as the
                engine produces it, then a final done line.  Replays after
                preemption never duplicate or roll back tokens."""
                q = server._streams[uid]
                total = 0
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    while True:
                        item = q.get()
                        if item is _STREAM_END:
                            break
                        total += len(item)
                        self._chunk(json.dumps(
                            {"uid": uid,
                             "tokens": item}).encode() + b"\n")
                finally:
                    # a client disconnect raises out of the writes above;
                    # the uid's queue/event/result must not leak
                    with server._lock:
                        done = uid in server._done
                        server._done.pop(uid, None)
                        server._streams.pop(uid, None)
                        server._events.pop(uid, None)
                        fatal = server._fatal
                tail = ({"uid": uid, "done": True, "tokens_total": total}
                        if done else
                        {"uid": uid, "error": fatal or "server closed"})
                self._chunk(json.dumps(tail).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")

        return Handler

    def _on_tokens(self, uid, new_tokens):
        """Runs on the scheduler thread (engine callback)."""
        if self._chained_on_tokens is not None:
            self._chained_on_tokens(uid, new_tokens)
        q = self._streams.get(uid)
        if q is not None:
            q.put(list(new_tokens))

    # ------------------------------------------------------------ plumbing
    def _submit(self, prompt, max_new, eos, temperature, stream=False):
        with self._lock:
            if self._stop.is_set() or self._fatal:
                raise RuntimeError(self._fatal or "server is closed")
            uid = self._next_uid
            self._next_uid += 1
            req = Request(uid=uid, prompt=prompt, max_new=max_new,
                          eos=eos, temperature=temperature,
                          arrival_t=time.perf_counter())
            # validate now so the caller gets a 422, not a wedged wait
            self.engine.validate_shape(req)
            self._pending.append(req)
            ev = threading.Event()
            self._events[uid] = ev
            if stream:
                self._streams[uid] = queue.Queue()
        self._wake.set()
        return uid, ev

    def _release_all_waiters(self) -> None:
        with self._lock:
            evs = list(self._events.values())
            qs = list(self._streams.values())
        for ev in evs:
            ev.set()
        for q in qs:
            q.put(_STREAM_END)

    def _scheduler(self):
        """Sole owner of the engine after start().  Any engine exception
        (a device error above all) is fatal: record it and release every
        waiting client with an error instead of a silent wedge."""
        try:
            while not self._stop.is_set():
                with self._lock:
                    new, self._pending = self._pending, []
                for r in new:
                    self.engine.submit(r)
                progressed = (self.engine.step() if self.engine.busy
                              else False)
                finished = self.engine.take_results()
                if finished:
                    with self._lock:
                        self._done.update(finished)
                        evs = [self._events[u] for u in finished
                               if u in self._events]
                        qs = [self._streams[u] for u in finished
                              if u in self._streams]
                    for ev in evs:
                        ev.set()
                    for q in qs:
                        q.put(_STREAM_END)
                if not progressed and not self.engine.busy:
                    self._wake.wait(timeout=0.25)  # idle: park
                    self._wake.clear()
                else:
                    time.sleep(0)                  # yield to HTTP threads
        except Exception as e:  # noqa: BLE001 — anything is fatal here
            with self._lock:
                self._fatal = f"engine failed: {type(e).__name__}: {e}"
        finally:
            self._release_all_waiters()

    # -------------------------------------------------------------- public
    def start(self) -> "ServingServer":
        self._sched = threading.Thread(target=self._scheduler,
                                       daemon=True)
        self._sched.start()
        self._http.start()
        return self

    def close(self) -> None:
        """Stop the scheduler and the listener, then the engine's other tp
        ranks (unless the scheduler is still inside a program, or their
        group has already failed: its error is kept in ``close_error``)."""
        self._stop.set()
        self._wake.set()
        if self._sched:
            self._sched.join(timeout=30)   # releases waiters on exit
        self._http.stop()
        if self._sched is None or not self._sched.is_alive():
            try:
                self.engine.close()
            except RuntimeError as e:      # a tp peer already gone
                self.close_error = f"{type(e).__name__}: {e}"
        # requests still in flight never finish: close their journal
        # records as evicted, so the ring ends with no dangling lifecycle
        self.engine.journal.evict_open("server-closed")
