"""Device-resident replay ring of (query, value) training examples.

Port of the uniform path of ``rebel_tpu/selfplay/replay.py`` (the
trained configuration's; priorities come with prioritized sampling):
rows are written in place into preallocated tensors on the device, the
newest ``capacity`` rows are kept, and ``num_add`` counts every row ever
added (it drives the trainer's train/gen throttle).  ``head``, ``size``
and ``num_add`` are host integers, so the throttle reads them without
waiting for the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass
class Replay:
    queries: torch.Tensor  # [C, Q] f32
    values: torch.Tensor  # [C, H] f32
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


def create(capacity: int, query_size: int, num_hands: int,
           device="cuda") -> Replay:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return Replay(queries=z(capacity, query_size),
                  values=z(capacity, num_hands))


def add(replay: Replay, queries: torch.Tensor,
        values: torch.Tensor) -> Replay:
    """Append K rows in place, overwriting the oldest beyond capacity."""
    K = queries.shape[0]
    C = replay.capacity
    dropped = max(K - C, 0)
    if dropped:  # keep the newest C rows; no duplicate slots in one write
        queries, values, K = queries[-C:], values[-C:], C
    idx = (replay.head + torch.arange(K, device=replay.queries.device)) % C
    replay.queries[idx] = queries.to(torch.float32)
    replay.values[idx] = values.to(torch.float32)
    replay.head = (replay.head + K) % C
    replay.size = min(replay.size + K, C)
    replay.num_add += K + dropped
    return replay


def sample_uniform(replay: Replay, gen: torch.Generator | None, batch: int,
                   indices: torch.Tensor | None = None) -> Sample:
    """Uniform draw of ``batch`` rows among the valid ones.  ``indices``
    (ring slots) replaces the draw, so a test can feed both packages the
    same rows."""
    C = replay.capacity
    dev = replay.queries.device
    if indices is None:
        off = torch.randint(0, max(replay.size, 1), (batch,), generator=gen,
                            device=dev)
        indices = (replay.head - 1 - off) % C
    else:
        indices = indices.to(device=dev, dtype=torch.long)
    return Sample(queries=replay.queries[indices],
                  values=replay.values[indices], indices=indices)
