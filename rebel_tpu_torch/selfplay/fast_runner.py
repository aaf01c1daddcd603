"""Depth-2 self-play engines and the engine factory.

Counterpart of ``rebel_tpu/selfplay/fast_runner.py``.  One ``batch_step``
solves every lane's depth-2 subgame, by CFR or by fictitious play, then
walks each lane one or two actions forward from the policy at its stop
iteration.  Three engines share that structure and the walk:

* :class:`FastCudaEngine` (counterpart of ``FastPallasEngine``): the whole
  solve is one kernel launch
  (:func:`rebel_tpu_torch.solving.grid2p.solve`);
* :class:`FastSelfPlayEngine`: the batch-first solver of
  :mod:`rebel_tpu_torch.solving.grid2` in plain PyTorch, on any device;
* :class:`FastBatchedEngine`: the batch-last solver of
  :mod:`rebel_tpu_torch.solving.grid2b` in plain PyTorch, on any device.

:func:`make_engine` picks between them and the generic
:class:`~rebel_tpu_torch.selfplay.runner.SelfPlayEngine`.  The walk is
split in two so that a test can feed the reference's random draws:

* :func:`draw_stop` and :func:`draw_actions` make every random choice
  (stop iteration, best-response player, explore coin, hands, actions)
  from one ``torch.Generator``;
* :func:`advance` applies Bayes belief updates, the terminal reset and
  the training queries for given actions, vectorised over lanes.

``jax.random`` and ``torch.Generator`` give different numbers, so the
port matches the reference in distribution, or exactly when the draws are
injected.
"""

from __future__ import annotations

import collections
import copy
import dataclasses

import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION
from rebel_tpu_torch.nets.value_nets import net_value_fn
from rebel_tpu_torch.parallel.distributed import Axis
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.core import (
    RootCtx,
    normalize_safe,
    reach_eps,
    root_action_mask,
    root_query,
)
from rebel_tpu_torch.solving.grid2 import Grid2Solver, local_hands
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
    SelfPlayEngine,
    StepOutput,
    _categorical,
    _sample_action,
    draw_stop,
)


def draw_actions(gen: torch.Generator, cfg: RecursiveSolvingParams,
                 ep: EpisodeState, p0: torch.Tensor, p1: torch.Tensor):
    """``(a1, a2)`` per lane from the solved policies ``p0 [B, H, A]`` and
    ``p1 [B, A, H, A]``; ``a2`` is ``None`` without ``sample_leaf``."""
    game = cfg.game
    B = p0.shape[0]
    dev = p0.device
    ar = torch.arange(B, device=dev)
    br_sampler = torch.randint(0, 2, (B,), generator=gen, device=dev)
    actor0 = ep.root_player
    a1 = _sample_action(gen, cfg, p0, root_action_mask(game, ep.root_bid),
                        ep.beliefs[ar, actor0], actor0 == br_sampler)
    if not cfg.sample_leaf:
        return a1, None
    actor1 = 1 - actor0
    a = torch.arange(game.num_actions, device=dev)
    m1_row = (a > a1[:, None]) & (a1 != game.liar_call)[:, None]
    # The level-1 actor's beliefs are unchanged by the root action.
    a2 = _sample_action(gen, cfg, p1[ar, a1], m1_row,
                        ep.beliefs[ar, actor1], actor1 == br_sampler)
    return a1, a2


def advance(cfg: RecursiveSolvingParams, ep: EpisodeState, p0: torch.Tensor,
            p1: torch.Tensor, vals: torch.Tensor, a1: torch.Tensor,
            a2: torch.Tensor | None):
    """Walk every lane along ``a1`` (and ``a2``) with Bayes updates
    ``b'(h) ~ b(h) pi(a|h)``; lanes that end restart from the initial
    state.  Returns the new state and the step's training examples (the
    root queries of the OLD state for traverser 0 and 1, and ``vals``)."""
    game = cfg.game
    liar = game.liar_call
    B = p0.shape[0]
    dev = p0.device
    ar = torch.arange(B, device=dev)
    eps_reach = reach_eps(ep.beliefs.dtype)
    queries = torch.stack(
        [root_query(game, ep.beliefs, t, ep.root_bid, ep.root_player)
         for t in (0, 1)],
        dim=1,
    )
    actor0 = ep.root_player
    beliefs = ep.beliefs.clone()
    beliefs[ar, actor0] = normalize_safe(
        beliefs[ar, actor0] * p0[ar, :, a1], eps_reach
    )
    done1 = a1 == liar
    if cfg.sample_leaf:
        actor1 = 1 - actor0
        stepped = beliefs.clone()
        stepped[ar, actor1] = normalize_safe(
            beliefs[ar, actor1] * p1[ar, a1, :, a2], eps_reach
        )
        beliefs = torch.where(done1[:, None, None], beliefs, stepped)
        new_bid = torch.where(done1, a1, a2)
        new_player = torch.where(done1, actor1, actor0)
        ended = done1 | (a2 == liar)
    else:
        new_bid = a1
        new_player = 1 - actor0
        ended = done1
    new_ep = EpisodeState(
        root_bid=torch.where(ended, INITIAL_ACTION, new_bid),
        root_player=torch.where(ended, 0, new_player),
        beliefs=torch.where(ended[:, None, None], 1.0 / game.num_hands,
                            beliefs),
    )
    return new_ep, StepOutput(queries=queries, values=vals, ended=ended)


def _depth2_only(cfg: RecursiveSolvingParams, name: str) -> None:
    depth = cfg.subgame_params.max_depth
    if depth != 2:
        raise ValueError(f"{name} runs depth-2 subgames (CFR or fictitious "
                         f"play), not depth {depth}")


@dataclasses.dataclass(frozen=True, eq=False)
class FastCudaEngine:
    """Self-play engine whose whole subgame solve runs in one kernel
    launch per ``batch_step`` on the card (the plain version on CPU
    tensors).  ``mlp_chunks``, ``gelu``, ``ablate`` and ``interleave`` are
    the kernel's options (see :mod:`rebel_tpu_torch.solving.grid2p`).
    ``lane_block=None`` lets :func:`rebel_tpu_torch.solving.grid2p.solve`
    choose it from the game and the batch; an explicit one that does not
    fit raises.  Keeps the CUDA event pairs around the last
    ``SOLVE_EVENTS`` solves in ``solve_events``, so a caller can read solve
    times after a synchronise."""

    SOLVE_EVENTS = 256

    cfg: RecursiveSolvingParams
    lane_block: int | None = None
    net_compute_dtype: torch.dtype = torch.float32
    mlp_chunks: int | None = None
    gelu: str = "auto"
    ablate: str = ""
    interleave: int = 1
    solve_events: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(
            maxlen=FastCudaEngine.SOLVE_EVENTS))

    def __post_init__(self):
        _depth2_only(self.cfg, "FastCudaEngine")

    def solve(self, eps: EpisodeState, t_stop: torch.Tensor, net):
        return grid2p.solve(
            self.cfg.game, self.cfg.subgame_params, eps.root_bid,
            eps.root_player, eps.beliefs, t_stop, net,
            self.net_compute_dtype, lane_block=self.lane_block,
            mlp_chunks=self.mlp_chunks, interleave=self.interleave,
            gelu=self.gelu, ablate=self.ablate,
        )

    def batch_step(self, eps: EpisodeState, net, gen: torch.Generator):
        dev = eps.beliefs.device
        B = eps.root_bid.shape[0]
        t = draw_stop(gen, B, self.cfg.subgame_params.num_iters, dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.solve(eps, t, net)
            end.record()
            self.solve_events.append((start, end))
        else:
            out = self.solve(eps, t, net)
        a1, a2 = draw_actions(gen, self.cfg, eps, out.snap0, out.snap1)
        return advance(self.cfg, eps, out.snap0, out.snap1, out.rvm, a1, a2)


@dataclasses.dataclass(frozen=True, eq=False)
class FastBatchedEngine:
    """Batch-last engine: all iterations of the plain depth-2 solver
    (:class:`rebel_tpu_torch.solving.grid2b.Grid2BatchSolver`, the lanes
    in the trailing axis) with the snapshot scan, on the device of the
    episodes.  The net runs with the module's own numerics (exact GELU,
    two-pass LayerNorm), wholly in ``net_compute_dtype``; the solve runs in
    ``dtype``."""

    cfg: RecursiveSolvingParams
    dtype: torch.dtype = torch.float32
    net_compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        _depth2_only(self.cfg, "FastBatchedEngine")

    def _mlp(self, net):
        """``x [Q, N] -> [H, N]`` through ``net`` (``None``: no net)."""
        if net is None:
            return None
        cdt = self.net_compute_dtype
        if next(net.parameters()).dtype != cdt:
            net = copy.deepcopy(net).to(cdt)
        return lambda x: net(x.T.to(cdt)).T

    @torch.no_grad()
    def batch_step(self, eps: EpisodeState, net, gen: torch.Generator):
        sub = self.cfg.subgame_params
        B = eps.root_bid.shape[0]
        t = draw_stop(gen, B, sub.num_iters, eps.beliefs.device)
        out = grid2p.solve_loop(self.cfg.game, sub, eps.root_bid,
                                eps.root_player, eps.beliefs, t,
                                self._mlp(net), self.dtype)
        a1, a2 = draw_actions(gen, self.cfg, eps, out.snap0, out.snap1)
        return advance(self.cfg, eps, out.snap0, out.snap1, out.rvm, a1, a2)


@dataclasses.dataclass(frozen=True, eq=False)
class FastSelfPlayEngine:
    """Batch-first engine: all iterations of the plain depth-2 solver
    (:class:`rebel_tpu_torch.solving.grid2.Grid2Solver`, the lanes in the
    leading axis) with the snapshot at each lane's stop iteration, on the
    device of the episodes.  ``net`` is a
    :class:`~rebel_tpu_torch.nets.cfv_net.CFVNet` (run by
    :func:`~rebel_tpu_torch.nets.value_nets.net_value_fn`, in its own
    dtype on queries in the solver's) or any value function; the solve
    runs in ``dtype``.

    With ``hands`` (an :class:`~rebel_tpu_torch.parallel.distributed.Axis`
    of ranks) the solve runs on this rank's slice of the hands, with the
    solver's sums over the axis every iteration, and the policies and
    root values are gathered once a subgame, so the walk and the examples
    see every hand.  The episodes and the generator are the same on every
    rank of the axis, so every rank draws the same numbers."""

    cfg: RecursiveSolvingParams
    dtype: torch.dtype = torch.float32
    hands: Axis | None = None

    def __post_init__(self):
        _depth2_only(self.cfg, "FastSelfPlayEngine")

    @torch.no_grad()
    def batch_step(self, eps: EpisodeState, net, gen: torch.Generator):
        sub = self.cfg.subgame_params
        game = self.cfg.game
        dev = eps.beliefs.device
        t = draw_stop(gen, eps.root_bid.shape[0], sub.num_iters, dev)
        solver = Grid2Solver(
            game=game, params=sub, dtype=self.dtype,
            value_fn=(net_value_fn(net) if isinstance(net, torch.nn.Module)
                      else net), device=dev, hands=self.hands)
        root = RootCtx.of(game, eps.root_bid, eps.root_player)
        state, (p0, p1) = solver.solve_with_snapshot(
            root, local_hands(self.hands, eps.beliefs), t)
        vals = state.root_values_means
        if self.hands is not None:
            p0 = self.hands.gather(p0, 1)  # [B, H, A]
            p1 = self.hands.gather(p1, 2)  # [B, A, H, A]
            vals = self.hands.gather(vals, 2)  # [B, 2, H]
        a1, a2 = draw_actions(gen, self.cfg, eps, p0, p1)
        return advance(self.cfg, eps, p0, p1, vals, a1, a2)


ENGINE_KINDS = ("auto", "generic", "fast", "batched", "kernel")


def make_engine(cfg: RecursiveSolvingParams, dtype=torch.float32,
                kind: str = "auto", net_compute_dtype=torch.float32,
                **kernel_options):
    """Engine factory.

    ``kind``: ``"generic"`` (:class:`SelfPlayEngine`, any depth),
    ``"fast"`` (:class:`FastSelfPlayEngine`), ``"batched"``
    (:class:`FastBatchedEngine`), ``"kernel"`` (:class:`FastCudaEngine`,
    the counterpart of the reference's ``"pallas"``; ``kernel_options`` are
    its ``lane_block``, ``mlp_chunks``, ``gelu``, ``ablate`` and
    ``interleave``), or ``"auto"``: ``"fast"`` where the depth is 2, else
    the generic one, as in the JAX package."""
    depth2 = cfg.subgame_params.max_depth == 2
    if kind == "auto":
        kind = "fast" if depth2 else "generic"
    if kind not in ENGINE_KINDS:
        raise ValueError(f"unknown engine kind {kind!r}")
    if kind != "generic" and not depth2:
        raise ValueError(f"engine kind {kind!r} requires max_depth == 2")
    if kernel_options and kind != "kernel":
        raise ValueError(f"{sorted(kernel_options)} are options of the "
                         f"'kernel' engine, not of {kind!r}")
    if kind == "generic":
        return SelfPlayEngine(cfg=cfg, dtype=dtype)
    if kind == "fast":
        return FastSelfPlayEngine(cfg=cfg, dtype=dtype)
    if kind == "batched":
        return FastBatchedEngine(cfg=cfg, dtype=dtype,
                                 net_compute_dtype=net_compute_dtype)
    return FastCudaEngine(cfg=cfg, net_compute_dtype=net_compute_dtype,
                          **kernel_options)
