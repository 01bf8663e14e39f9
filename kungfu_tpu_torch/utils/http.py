"""Embedded background HTTP server (a copy of kungfu_tpu/utils/http.py,
stdlib only, kept here so the port imports nothing of kungfu_tpu)."""
from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Callable, Optional


class BackgroundHTTPServer:
    """A ThreadingHTTPServer on a daemon thread with start/stop lifecycle."""

    def __init__(self, handler_factory: Callable[["BackgroundHTTPServer"], type],
                 host: str = "127.0.0.1", port: int = 0):
        self._http = ThreadingHTTPServer((host, port), handler_factory(self))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._http.server_address[1]

    @property
    def host(self) -> str:
        return self._http.server_address[0]

    def start(self):
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()

    def shutdown_async(self) -> None:
        """Shut down from inside a request handler without deadlocking."""
        threading.Thread(target=self._http.shutdown, daemon=True).start()

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
