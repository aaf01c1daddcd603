"""Device-resident replay ring of (query, value) training examples, the
counterpart of ``rebel_tpu/selfplay/replay.py``.

Rows are written in place into preallocated tensors on the device, the
newest ``capacity`` rows are kept, and ``num_add`` counts every row ever
added (it drives the trainer's train/gen throttle).  ``head``, ``size``
and ``num_add`` are host integers, so the throttle reads them without
waiting for the device.

* Priorities are stored as ``priority ** alpha`` when a row is added.
* Prioritized sampling is stratified: the total priority is cut into
  ``batch`` equal segments, one uniform draw per segment is inverted
  through the cumulative sum, and the importance weights are
  ``(size * w / total) ** -beta`` over their maximum.  Uniform sampling
  (the trained configuration's) draws rows uniformly.
* On disk a dataset is the reference binary format, per row
  ``[int32 qsize][int32 vsize][qsize f32][vsize f32]``: files are byte for
  byte those of the JAX package, and each package reads the other's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class Replay:
    queries: torch.Tensor  # [C, Q] f32
    values: torch.Tensor  # [C, H] f32
    priorities: torch.Tensor  # [C] f32, already ** alpha
    head: int = 0  # next write slot
    size: int = 0  # valid rows
    num_add: int = 0  # rows ever appended

    @property
    def capacity(self) -> int:
        return self.queries.shape[0]


class Sample(NamedTuple):
    queries: torch.Tensor  # [N, Q]
    values: torch.Tensor  # [N, H]
    indices: torch.Tensor  # [N] ring slots
    weights: torch.Tensor  # [N] importance; uniform: 1 (0 on an empty ring)


def create(capacity: int, query_size: int, num_hands: int,
           device="cuda") -> Replay:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return Replay(queries=z(capacity, query_size),
                  values=z(capacity, num_hands), priorities=z(capacity))


def add(replay: Replay, queries: torch.Tensor, values: torch.Tensor,
        priority: torch.Tensor | float = 1.0, alpha: float = 1.0) -> Replay:
    """Append K rows in place, overwriting the oldest beyond capacity.
    Self-play pushes with priority 1."""
    K = queries.shape[0]
    C = replay.capacity
    dev = replay.queries.device
    dropped = max(K - C, 0)
    prio = torch.as_tensor(priority, dtype=torch.float32, device=dev)
    if dropped:  # keep the newest C rows; no duplicate slots in one write
        queries, values, K = queries[-C:], values[-C:], C
        if prio.dim():
            prio = prio[-C:]
    idx = (replay.head + torch.arange(K, device=dev)) % C
    replay.queries[idx] = queries.to(device=dev, dtype=torch.float32)
    replay.values[idx] = values.to(device=dev, dtype=torch.float32)
    replay.priorities[idx] = prio.broadcast_to((K,)) ** float(alpha)
    replay.head = (replay.head + K) % C
    replay.size = min(replay.size + K, C)
    replay.num_add += K + dropped
    return replay


def _newest(replay: Replay, offsets: torch.Tensor) -> torch.Tensor:
    """Ring slots ``offsets`` rows back from the newest."""
    return (replay.head - 1 - offsets) % replay.capacity


def sample_uniform(replay: Replay, gen: torch.Generator | None, batch: int,
                   indices: torch.Tensor | None = None) -> Sample:
    """Uniform draw of ``batch`` rows among the valid ones.  ``indices``
    (ring slots) replaces the draw, so a test can feed both packages the
    same rows."""
    dev = replay.queries.device
    if indices is None:
        off = torch.randint(0, max(replay.size, 1), (batch,), generator=gen,
                            device=dev)
        indices = _newest(replay, off)
    else:
        indices = indices.to(device=dev, dtype=torch.long)
    weights = torch.full((indices.shape[0],), float(replay.size > 0),
                         device=dev)
    return Sample(queries=replay.queries[indices],
                  values=replay.values[indices], indices=indices,
                  weights=weights)


def valid_mask(replay: Replay) -> torch.Tensor:
    """``[C]`` bool: the ``size`` most recently written slots."""
    C = replay.capacity
    slot = torch.arange(C, device=replay.queries.device)
    return (replay.head - 1 - slot) % C < replay.size


def sample_prioritized(replay: Replay, gen: torch.Generator | None,
                       batch: int, beta: float,
                       u: torch.Tensor | None = None) -> Sample:
    """Stratified priority sampling with importance weights.  ``u
    [batch]`` in [0, 1) replaces the uniform draws, one per segment."""
    C = replay.capacity
    dev = replay.queries.device
    w = torch.where(valid_mask(replay), replay.priorities, 0.0)
    cum = torch.cumsum(w, 0)
    total = cum[-1]
    segment = total / batch
    if u is None:
        u = torch.rand((batch,), generator=gen, device=dev)
    u = u.to(device=dev, dtype=torch.float32)
    targets = (torch.arange(batch, device=dev) + u) * segment
    targets = torch.minimum(targets, total * (1 - 1e-7))
    idx = torch.searchsorted(cum, targets, right=True).clamp(max=C - 1)
    wi = w[idx]
    iw = (replay.size * wi / torch.clamp(total, min=1e-30)) ** (-beta)
    # A slot of zero priority (an empty ring, or a zero-priority slot hit
    # at the cumulative sum's boundary) carries no probability mass: its
    # weight is 0, not inf.
    iw = torch.where(wi > 0, iw, 0.0)
    iw = iw / torch.clamp(iw.max(), min=1e-30)
    return Sample(queries=replay.queries[idx], values=replay.values[idx],
                  indices=idx, weights=iw)


def update_priority(replay: Replay, indices: torch.Tensor,
                    priority: torch.Tensor, alpha: float = 1.0) -> Replay:
    """Set the priorities of ring slots ``indices`` (in place)."""
    dev = replay.priorities.device
    prio = torch.as_tensor(priority, dtype=torch.float32, device=dev)
    replay.priorities[torch.as_tensor(indices, device=dev)] = \
        prio ** float(alpha)
    return replay


def pop_until(replay: Replay, new_size: int) -> Replay:
    """Drop the oldest rows until ``size <= new_size`` (in place)."""
    replay.size = min(replay.size, int(new_size))
    return replay


# ------------------------------------------------------------------ disk
def extract(replay: Replay) -> tuple[np.ndarray, np.ndarray]:
    """Host copies of the valid rows, oldest first."""
    C = replay.capacity
    order = torch.as_tensor((replay.head - replay.size
                             + np.arange(replay.size)) % C,
                            device=replay.queries.device)
    return (replay.queries[order].cpu().numpy(),
            replay.values[order].cpu().numpy())


def save(replay: Replay, path, stride: int = 1) -> int:
    """Write every ``stride``-th valid row, oldest first, in the reference
    binary format; returns the number of rows written."""
    q, v = extract(replay)
    q, v = q[::stride], v[::stride]
    n, qsize, vsize = q.shape[0], q.shape[1], v.shape[1]
    # One structured array, one write.
    rec = np.zeros(n, dtype=[("qsize", "<i4"), ("vsize", "<i4"),
                             ("q", "<f4", (qsize,)), ("v", "<f4", (vsize,))])
    rec["qsize"] = qsize
    rec["vsize"] = vsize
    rec["q"] = q
    rec["v"] = v
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return n


def load_file(path, max_size: int | None = None, stride: int = 1):
    """``(queries, values)`` numpy arrays of a dataset in the reference
    binary format: every ``stride``-th row, at most ``max_size``."""
    qs, vs = [], []
    with open(path, "rb") as f:
        i = 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            qsize, vsize = struct.unpack("ii", hdr)
            q = np.frombuffer(f.read(4 * qsize), "<f4")
            v = np.frombuffer(f.read(4 * vsize), "<f4")
            if i % stride == 0:
                qs.append(q)
                vs.append(v)
            i += 1
            if max_size is not None and len(qs) >= max_size:
                break
    if not qs:
        raise ValueError(f"dataset dump {str(path)!r} contains no rows (empty "
                         "or truncated before the first record)")
    return np.stack(qs), np.stack(vs)


def load_into(replay: Replay, path, priority: float = 1.0,
              alpha: float = 1.0, max_size: int | None = None,
              stride: int = 1) -> Replay:
    """Append a dataset file's rows to the ring (in place)."""
    q, v = load_file(path, max_size=max_size, stride=stride)
    return add(replay, torch.from_numpy(q), torch.from_numpy(v), priority,
               alpha)


# ------------------------------------------------------------ compression
def quantize(values: torch.Tensor) -> torch.Tensor:
    """Byte-quantize values in [0, 1]."""
    return torch.clamp(values * 255 + 0.5, 0.0, 255.5).to(torch.uint8)


def dequantize(values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize`."""
    return values.to(torch.float32) / 255.0
