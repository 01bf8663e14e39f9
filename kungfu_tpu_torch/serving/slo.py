"""Request journal and SLO evaluation for the serving path (a private
copy of kungfu_tpu/serving/slo.py; the port imports nothing of the JAX
package).

- :class:`RequestJournal`: every request's lifecycle (arrival, each
  admission, first token, finish) in a bounded in-memory ring, plus an
  optional JSONL sink (``kfrequests.<pid>.jsonl`` under ``sink_dir``,
  opened with an anchor record that pairs the engine's
  ``time.perf_counter()`` clock with the wall clock).  Served live as
  ``GET /requests`` by :class:`~kungfu_tpu_torch.serving.ServingServer`.
- :class:`SLO`: one latency objective (ttft, tpot or e2e).
- :func:`evaluate`: per-window compliance and error-budget burn rate
  ((1 - compliance) / (1 - percentile): 1.0 spends the budget exactly
  as provisioned).

The JAX package reads these settings from environment variables; here
they are constructor arguments with the same defaults.  Its monitor
gauges (``publish``) and trace events are not ported.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["SLO", "RequestRecord", "RequestJournal", "default_slos",
           "evaluate", "burn_rate", "OBJECTIVES", "PHASES"]

OBJECTIVES = ("ttft", "tpot", "e2e")
PHASES = ("queue", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One latency objective: ``percentile`` of the requests in the
    compliance window must come in under ``target_ms``."""
    objective: str        # ttft | tpot | e2e
    target_ms: float
    percentile: float
    window: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_slos(ttft_ms: float = 2000.0, tpot_ms: float = 200.0,
                 e2e_ms: float = 10000.0, percentile: float = 0.95,
                 window: int = 64) -> List[SLO]:
    """The enabled objectives (a target of 0 disables one); the defaults
    are the JAX package's knob defaults."""
    return [SLO(obj, float(t), float(percentile), int(window))
            for obj, t in (("ttft", ttft_ms), ("tpot", tpot_ms),
                           ("e2e", e2e_ms)) if t > 0]


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle.  ``arrival_t`` is the original arrival
    (it survives preemption re-queues; the engine's ``Request`` keeps a
    separate re-stamped clock for the current wait); ``queue_wait_s``
    accumulates across every admission."""
    uid: int
    arrival_t: float
    prompt_tokens: int = 0
    admit_t: Optional[float] = None        # most recent admission
    first_token_t: Optional[float] = None  # set once, survives replay
    finish_t: Optional[float] = None
    output_tokens: int = 0
    prefix_reused: int = 0                 # cache-hit depth (tokens)
    preemptions: int = 0
    queue_wait_s: float = 0.0              # cumulative across requeues
    slot: Optional[int] = None
    outcome: Optional[str] = None          # finish | evict

    # -- derived latencies (ms; None until the phase completes) -------
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.arrival_t) * 1e3

    def tpot_ms(self) -> Optional[float]:
        if (self.finish_t is None or self.first_token_t is None
                or self.output_tokens < 2):
            return None
        return ((self.finish_t - self.first_token_t)
                / (self.output_tokens - 1)) * 1e3

    def e2e_ms(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return (self.finish_t - self.arrival_t) * 1e3

    def value_ms(self, objective: str) -> Optional[float]:
        if objective == "ttft":
            return self.ttft_ms()
        if objective == "tpot":
            return self.tpot_ms()
        if objective == "e2e":
            return self.e2e_ms()
        raise ValueError(f"unknown objective {objective!r}")

    def phase_s(self) -> Dict[str, float]:
        """Wall seconds spent per lifecycle phase (finished requests)."""
        out = {"queue": self.queue_wait_s, "prefill": 0.0, "decode": 0.0}
        if self.admit_t is not None and self.first_token_t is not None:
            out["prefill"] = max(self.first_token_t - self.admit_t, 0.0)
        if self.first_token_t is not None and self.finish_t is not None:
            out["decode"] = max(self.finish_t - self.first_token_t, 0.0)
        return out

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ttft_ms"] = self.ttft_ms()
        d["tpot_ms"] = self.tpot_ms()
        d["e2e_ms"] = self.e2e_ms()
        return d


def burn_rate(compliance: float, percentile: float) -> float:
    """Error-budget burn: miss fraction over budgeted miss fraction."""
    budget = max(1.0 - percentile, 1e-9)
    return max(1.0 - compliance, 0.0) / budget


def evaluate(records: List[RequestRecord],
             slos: List[SLO]) -> Dict[str, dict]:
    """Per-objective compliance and burn over each SLO's window (the
    most recent ``window`` finished records)."""
    out: Dict[str, dict] = {}
    for slo in slos:
        values = [v for v in (r.value_ms(slo.objective)
                              for r in records[-slo.window:])
                  if v is not None]
        n = len(values)
        ok = sum(1 for v in values if v <= slo.target_ms)
        compliance = (ok / n) if n else 1.0
        out[slo.objective] = {
            "target_ms": slo.target_ms,
            "percentile": slo.percentile,
            "window": slo.window,
            "n": n,
            "compliance": compliance,
            "burn": burn_rate(compliance, slo.percentile),
            "worst_ms": max(values, default=0.0),
        }
    return out


class RequestJournal:
    """Bounded per-request journal: open records by uid, a finished
    ring of ``ring`` records, and an optional JSONL sink under
    ``sink_dir`` (None: no sink) rotated once past ``max_bytes`` (one
    ``.1`` generation kept).

    Mutated only by the engine's owner thread; ``snapshot()`` is read
    from HTTP handler threads, so every access takes the lock.
    """

    def __init__(self, *, ring: int = 1024, sink_dir: Optional[str] = None,
                 max_bytes: int = 16_000_000,
                 slos: Optional[List[SLO]] = None):
        self.slos = default_slos() if slos is None else list(slos)
        self._lock = threading.Lock()
        self._open: Dict[int, RequestRecord] = {}
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, ring))
        self._max_bytes = max(int(max_bytes), 4096)
        self._sink = None
        self.sink_path: Optional[str] = None
        if sink_dir:
            os.makedirs(sink_dir, exist_ok=True)
            self.sink_path = os.path.join(
                sink_dir, f"kfrequests.{os.getpid()}.jsonl")
            self._sink = open(self.sink_path, "a")
            self._write_anchor()

    # -- sink ---------------------------------------------------------
    def _write_anchor(self) -> None:
        self._sink.write(json.dumps(
            {"kind": "anchor", "wall": time.time(),
             "mono": time.perf_counter(), "pid": os.getpid()}) + "\n")
        self._sink.flush()

    def _sink_write(self, record: RequestRecord) -> None:
        if self._sink is None:
            return
        if self._sink.tell() > self._max_bytes:
            # one rotated generation; the fresh stream re-anchors
            self._sink.close()
            os.replace(self.sink_path, self.sink_path + ".1")
            self._sink = open(self.sink_path, "a")
            self._write_anchor()
        self._sink.write(json.dumps(record.to_dict()) + "\n")
        self._sink.flush()

    # -- lifecycle hooks (engine owner thread) ------------------------
    def on_submit(self, uid: int, arrival_t: float,
                  prompt_tokens: int) -> None:
        with self._lock:
            self._open[uid] = RequestRecord(
                uid=uid, arrival_t=arrival_t, prompt_tokens=prompt_tokens)

    def on_admit(self, uid: int, t: float, *, slot: int,
                 prefix_reused: int, wait_s: float) -> None:
        with self._lock:
            rec = self._open.get(uid)
            if rec is None:
                return
            rec.admit_t = t
            rec.slot = slot
            rec.prefix_reused = prefix_reused
            rec.queue_wait_s += max(wait_s, 0.0)

    def on_first_token(self, uid: int, t: float) -> None:
        with self._lock:
            rec = self._open.get(uid)
            if rec is not None and rec.first_token_t is None:
                rec.first_token_t = t

    def on_preempt(self, uid: int) -> None:
        with self._lock:
            rec = self._open.get(uid)
            if rec is not None:
                rec.preemptions += 1
                rec.slot = None

    def on_finish(self, uid: int, t: float, *, output_tokens: int,
                  outcome: str = "finish") -> Optional[RequestRecord]:
        with self._lock:
            rec = self._open.pop(uid, None)
            if rec is None:
                return None
            rec.finish_t = t
            rec.output_tokens = output_tokens
            rec.outcome = outcome
            self._ring.append(rec)
            self._sink_write(rec)
        return rec

    def evict_open(self, reason: str = "shutdown") -> List[RequestRecord]:
        """Close every in-flight record as evicted (server teardown).
        ``reason`` labels the JAX package's trace event, which is not
        ported; the records read ``outcome: "evict"`` either way."""
        now = time.perf_counter()
        with self._lock:
            evicted = list(self._open.values())
            for rec in evicted:
                rec.finish_t = now
                rec.outcome = "evict"
                self._ring.append(rec)
                self._sink_write(rec)
            self._open.clear()
        return evicted

    # -- read side ----------------------------------------------------
    def finished(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._ring)

    def snapshot(self, n: int = 64) -> dict:
        with self._lock:
            done = list(self._ring)
            open_ = list(self._open.values())
        return {
            "open": [r.to_dict() for r in open_],
            "finished": [r.to_dict() for r in done[-max(n, 0):]],
            "slo": evaluate(done, self.slos),
        }

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
