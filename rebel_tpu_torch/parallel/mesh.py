"""SPMD self-play training over ranks, the counterpart of
``rebel_tpu/parallel/mesh.py``.

The JAX package runs one ``shard_map`` program over a device mesh.  The
port runs one process per rank with explicit collectives, PyTorch's
idiom, over the same layout:

* ranks form a ``data x hands`` grid, rank ``d * n_hands + h`` (as
  ``devices.reshape(n_data, n_hands)`` lays them out), with a process
  group per axis (:class:`RankLayout`);
* self-play lanes are split over ``data``: each data rank advances its
  own lanes with its own generator into its own replay ring (the
  reference's per-rank buffers);
* the learner samples a local batch uniformly from the local ring, and
  the gradients and the loss are averaged over ``data`` (JAX's ``pmean``),
  so the replicated net and optimizer stay identical on every rank;
* with a hands axis each data shard's subgame solves are split over the
  hands (the ``fast`` engine's ``hands``); episodes, rings, generators and
  the net are the same on every rank of a hands group.

Sizes are the JAX package's: ``local_lanes = selfplay_batch // n_data``,
``local_batch = train_batch_size // n_data``, ``local_capacity =
max(replay_capacity // n_data, 4 * local_batch)``.  Host copies of the
rings (:func:`gather_to_host`) keep the JAX package's layout: ``n_data``
row segments of one array with a ``head``, ``size`` and ``num_add`` each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.parallel.distributed import (
    SOLO,
    Axis,
    broadcast_,
    group_size,
)
from rebel_tpu_torch.selfplay import replay as rb
from rebel_tpu_torch.selfplay.runner import EpisodeState

RING_KEYS = ("queries", "values", "priorities")
COUNT_KEYS = ("head", "size", "num_add")


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """The ``data x hands`` grid of ranks and this rank's place in it."""

    n_data: int
    n_hands: int
    rank: int
    data: Axis
    hands: Axis

    @property
    def world(self) -> int:
        return self.n_data * self.n_hands

    @property
    def is_master(self) -> bool:
        return self.rank == 0


def make_layout(n_hands: int = 1) -> RankLayout:
    """Every rank of the process group (or this process alone) in a grid
    of ``world // n_hands`` data ranks by ``n_hands`` hands ranks.  Every
    rank must call this, in the same order as the others: it makes the
    axes' process groups."""
    world = group_size()
    if world % n_hands:
        raise ValueError(f"launcher.hands={n_hands} must divide the number "
                         f"of ranks {world}")
    n_data = world // n_hands
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, h = divmod(rank, n_hands)
    if n_hands == 1:
        data_group, hands_group = None, SOLO
    elif n_data == 1:
        data_group, hands_group = SOLO, None
    else:
        data_group = hands_group = SOLO
        for hh in range(n_hands):
            g = dist.new_group([dd * n_hands + hh for dd in range(n_data)])
            data_group = g if hh == h else data_group
        for dd in range(n_data):
            g = dist.new_group([dd * n_hands + hh for hh in range(n_hands)])
            hands_group = g if dd == d else hands_group
    return RankLayout(n_data, n_hands, rank, Axis(data_group, n_data, d),
                      Axis(hands_group, n_hands, h))


@dataclasses.dataclass
class SpmdState:
    """One rank's share of the SPMD state; the net and the optimizer are
    the trainer's (replicated)."""

    episodes: EpisodeState  # this rank's lanes
    replay: rb.Replay  # this rank's ring
    gen: torch.Generator  # this data rank's stream


def rank_seed(seed: int, data_index: int) -> int:
    """The generator seed of data rank ``data_index`` under ``seed``."""
    lo, hi = np.random.SeedSequence([seed, data_index]).generate_state(
        2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def flat_params(net: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


# ----------------------------------------------------------- host copies
def gather_to_host(axis: Axis, parts: dict) -> dict:
    """Host copies of ``parts`` (tensors with a leading axis per rank)
    concatenated over ``axis`` in rank order.  A collective: every rank
    of the axis calls it."""
    return {k: axis.gather(v, 0).cpu() for k, v in parts.items()}


def ring_parts(replay: rb.Replay) -> dict:
    """A ring as tensors to gather: rows, and its counts as ``[1]``."""
    dev = replay.queries.device
    return {**{k: getattr(replay, k) for k in RING_KEYS},
            **{k: torch.tensor([getattr(replay, k)], device=dev)
               for k in COUNT_KEYS}}


def ring_valid_rows(host: dict, n_dev: int) -> tuple[np.ndarray, np.ndarray]:
    """The valid ``(queries, values)`` rows of a host copy of ``n_dev``
    rings, oldest first within each ring."""
    local_cap = host["queries"].shape[0] // n_dev
    qs, vs = [], []
    for d in range(n_dev):
        size, head = int(host["size"][d]), int(host["head"][d])
        order = d * local_cap + (head - size + np.arange(size)) % local_cap
        qs.append(np.asarray(host["queries"])[order])
        vs.append(np.asarray(host["values"])[order])
    return np.concatenate(qs), np.concatenate(vs)


def rows_to_ring(base: dict, rows_q: np.ndarray, rows_v: np.ndarray,
                 n_dev: int) -> dict:
    """Dataset rows dealt round-robin into ``n_dev`` empty rings of the
    host layout ``base`` (each keeps its newest ``local_cap`` rows)."""
    local_cap = base["queries"].shape[0] // n_dev
    out = {k: np.array(base[k], copy=True) for k in RING_KEYS}
    counts = {k: np.zeros((n_dev,), np.int64) for k in COUNT_KEYS}
    for d in range(n_dev):
        rq, rv = rows_q[d::n_dev], rows_v[d::n_dev]
        n = len(rq)
        keep = min(n, local_cap)
        seg = slice(d * local_cap, d * local_cap + keep)
        out["queries"][seg] = rq[n - keep:]
        out["values"][seg] = rv[n - keep:]
        out["priorities"][seg] = 1.0
        counts["head"][d] = keep % local_cap
        counts["size"][d] = keep
        counts["num_add"][d] = n
    return {**out, **counts}


def ring_segment(host: dict, d: int, replay: rb.Replay) -> None:
    """Load segment ``d`` of a host copy of the rings into ``replay`` (in
    place)."""
    cap = replay.capacity
    for k in RING_KEYS:
        getattr(replay, k).copy_(torch.as_tensor(
            np.asarray(host[k][d * cap:(d + 1) * cap])))
    for k in COUNT_KEYS:
        setattr(replay, k, int(host[k][d]))


# -------------------------------------------------------------- programs
def make_spmd_programs(trainer, layout: RankLayout, hands: bool = False):
    """``(init_state, gen_step, train_step)`` of this rank for
    ``trainer`` (a :class:`~rebel_tpu_torch.training.trainer.Trainer`,
    whose sizes are global).  With ``hands`` the trainer's engine solves
    on this rank's slice of the hands of ``layout.hands``.

    * ``init_state(seed) -> SpmdState``: the net from ``seed`` broadcast
      from rank 0, a fresh optimizer, this rank's lanes, ring and
      generator;
    * ``gen_step(state)``: one engine step on the local lanes into the
      local ring;
    * ``train_step(state, indices=None) -> stats``: a uniform local
      sample (``indices``, ring slots, replaces the draw), gradients and
      loss averaged over the data axis, the clipped optimizer step, and
      the per-last-action sums over the data axis."""
    cfg = trainer.cfg
    game = trainer.game
    engine = trainer.engine
    if hands:
        if not hasattr(engine, "hands"):
            raise ValueError(f"engine {type(engine).__name__} does not "
                             "support hands sharding (use engine='fast')")
        engine = dataclasses.replace(engine, hands=layout.hands)
        assert game.num_hands % layout.n_hands == 0, (
            f"hands-axis size {layout.n_hands} must divide "
            f"num_hands={game.num_hands}")
    n_dev = layout.n_data
    assert cfg.selfplay_batch % n_dev == 0, "lanes must divide devices"
    assert cfg.train_batch_size % n_dev == 0, "batch must divide devices"
    local_lanes = cfg.selfplay_batch // n_dev
    local_batch = cfg.train_batch_size // n_dev
    local_capacity = max(cfg.replay_capacity // n_dev, 4 * local_batch)
    dev = trainer.device

    def init_state(seed: int = 0) -> SpmdState:
        fresh = CFVNet(game, cfg.n_hidden, cfg.n_layers, cfg.use_layer_norm,
                       generator=torch.Generator().manual_seed(seed))
        trainer.net.load_state_dict(fresh.state_dict())
        with torch.no_grad():
            for p in trainer.net.parameters():
                broadcast_(p.data, 0)
        trainer.reset_optimizer()
        return SpmdState(
            episodes=EpisodeState.initial_batch(game, local_lanes, dev,
                                                cfg.solver_dtype),
            replay=rb.create(local_capacity, game.query_size,
                             game.num_hands, dev),
            gen=torch.Generator(dev).manual_seed(
                rank_seed(seed, layout.data.index)))

    def gen_step(state: SpmdState) -> None:
        state.episodes, out = engine.batch_step(state.episodes, trainer.net,
                                                state.gen)
        rb.add(state.replay, out.queries.reshape(-1, game.query_size),
               out.values.reshape(-1, game.num_hands), 1.0,
               cfg.replay_alpha)
        trainer.gen_steps += 1

    def train_step(state: SpmdState, indices: torch.Tensor | None = None):
        sample = rb.sample_uniform(state.replay, state.gen, local_batch,
                                   indices)
        loss, per_ex = trainer.loss_fn(sample.queries, sample.values)
        trainer.opt.zero_grad(set_to_none=True)
        loss.backward()
        params = list(trainer.net.parameters())
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1)])
        flat = layout.data.psum_(flat) / n_dev  # pmean
        k = 0
        for p in params:
            p.grad.copy_(flat[k:k + p.numel()].view_as(p))
            k += p.numel()
        g_norm = trainer.clipped_step()
        sums = trainer.bucket_sums(sample, per_ex)
        stacked = layout.data.psum_(torch.stack(list(sums.values())))
        return dict(loss=flat[-1], g_norm=g_norm,
                    **dict(zip(sums, stacked.unbind(0))))

    return init_state, gen_step, train_step
