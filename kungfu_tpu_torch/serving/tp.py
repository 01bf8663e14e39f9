"""Tensor-parallel serving across processes (the JAX engine's ``mesh=``
path, one process per tp rank).

The JAX engine drives every tp device from one process: each program is
one ``shard_map`` and the host scheduler does not know tp exists.  Here
each rank is a process.  Rank 0 (the **driver**) owns the scheduler, the
HTTP server and the journal; the other ranks (**followers**) hold their
shards and run the same programs on the same host inputs, in the same
order:

* before each program the driver sends one **command**: the program's
  name and its host arrays (tables, positions, tokens, uids, counts,
  sampling settings, rows) packed into one buffer (:func:`pack`), over the
  mesh's gloo **control group** of CPU tensors whatever the data
  backend is (:class:`Channel`);
* inside a program the only collectives are the all-reduces of the
  partial attention-output and FFN products and the all-gather of the
  vocabulary-sharded logits, over the data group (:class:`TPComm`);
* after it, one all-gather over the control group carries every rank's
  tokens and counters, and the engine raises unless the tokens agree
  (the JAX engine's ``pmax`` proves replication; here it is checked).

A follower waits for its next command on the control group, whose
timeout is ``comm.mesh.CONTROL_TIMEOUT``, so the server may idle as long
as it likes; a dead peer fails the wait at once (gloo closes its
sockets).  ``DecodeEngine.close`` sends the stop command.
"""
from __future__ import annotations

import json
import struct
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import gpt as G

STOP = "stop"


def pack(op: str, arrays: Dict[str, np.ndarray]) -> np.ndarray:
    """One uint8 buffer: an 8-byte length, a JSON header (the op and each
    array's name, dtype and shape) and the arrays' bytes in order."""
    arrays = {k: np.ascontiguousarray(a) for k, a in arrays.items()}
    meta = json.dumps({"op": op, "arrays": [
        [k, a.dtype.str, list(a.shape)] for k, a in arrays.items()]}
    ).encode()
    parts = [np.frombuffer(struct.pack("<q", len(meta)), np.uint8),
             np.frombuffer(meta, np.uint8)]
    parts += [a.reshape(-1).view(np.uint8) for a in arrays.values()]
    return np.concatenate(parts)


def unpack(buf: np.ndarray) -> Tuple[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`pack` (copies: the buffer may be reused)."""
    n = struct.unpack("<q", buf[:8].tobytes())[0]
    meta = json.loads(buf[8:8 + n].tobytes())
    off, out = 8 + n, {}
    for name, dtype, shape in meta["arrays"]:
        dt = np.dtype(dtype)
        size = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        out[name] = buf[off:off + size].view(dt).reshape(shape).copy()
        off += size
    return meta["op"], out


class Channel:
    """Rank 0's commands to the other ranks of a control group: a length,
    then the packed buffer, each one ``broadcast``."""

    def __init__(self, group):
        self.group = group
        self.root = dist.get_global_rank(group, 0)

    def send(self, op: str, arrays: Dict[str, np.ndarray]) -> None:
        buf = torch.from_numpy(pack(op, arrays))
        dist.broadcast(torch.tensor([buf.numel()], dtype=torch.int64),
                       self.root, group=self.group)
        dist.broadcast(buf, self.root, group=self.group)

    def recv(self) -> Tuple[str, Dict[str, np.ndarray]]:
        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, self.root, group=self.group)
        buf = torch.empty(int(n.item()), dtype=torch.uint8)
        dist.broadcast(buf, self.root, group=self.group)
        return unpack(buf.numpy())


class TPComm:
    """One serving rank's collectives inside the programs, forward only,
    and the seconds they take: CUDA events around each on the current
    stream (the stream's stall for the collective, read after the
    program's sync), or the host clock for CPU tensors."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.cuda = device.type == "cuda"
        self.seconds = 0.0
        self._events = []

    def _timed(self, fn, t):
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn(t, self.group)
            b.record()
            self._events.append((a, b))
            return out
        t0 = time.perf_counter()
        out = fn(t, self.group)
        self.seconds += time.perf_counter() - t0
        return out

    def psum(self, t):
        """The rank's partial product summed over tp, in place."""
        return self._timed(G._tp_sum, t)

    def gather(self, t):
        """The ranks' blocks of the last axis joined in rank order."""
        return self._timed(G._tp_gather, t)

    def settle(self) -> float:
        """Add the recorded collectives' device time (the program has been
        synchronised) to ``seconds``; returns the total."""
        for a, b in self._events:
            self.seconds += a.elapsed_time(b) / 1e3
        self._events.clear()
        return self.seconds
