"""Depth-2 self-play engine around the fused CUDA solve.

Counterpart of ``FastPallasEngine`` in ``rebel_tpu/selfplay/fast_runner.py``.
One ``batch_step`` solves every lane's subgame, by CFR or by fictitious
play, in one kernel launch
(:func:`rebel_tpu_torch.solving.grid2p.solve`), then walks each lane one
or two actions forward from the policy at its stop iteration.  The walk
is split in two so that a test can feed the reference's random draws:

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
import dataclasses
import math

import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.core import (
    normalize_safe,
    reach_eps,
    root_action_mask,
    root_query,
)
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
    StepOutput,
)


def draw_stop(gen: torch.Generator, batch: int, num_iters: int,
              device) -> torch.Tensor:
    """Per-lane stop iteration ``t ~ U{0, ..., num_iters}``."""
    return torch.randint(0, num_iters + 1, (batch,), generator=gen,
                         device=device)


def _categorical(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row of unnormalised ``probs [N, K]``.  Rows without
    mass (a level-1 row after the liar call, whose draw is never used)
    draw uniformly instead of failing."""
    has = probs.sum(-1, keepdim=True) > 0
    probs = torch.where(has, probs, torch.ones_like(probs))
    return torch.multinomial(probs, 1, generator=gen).squeeze(-1)


def _sample_action(gen, cfg: RecursiveSolvingParams, policy: torch.Tensor,
                   mask: torch.Tensor, bel_actor: torch.Tensor,
                   explore_ok: torch.Tensor) -> torch.Tensor:
    """With probability ``random_action_prob`` (for the best-response
    sampled player) uniform over legal actions, else a hand from the
    actor's beliefs and then an action from ``policy[hand]``.
    ``policy [B, H, A]``, ``mask [B, A]``, ``bel_actor [B, H]``."""
    B = policy.shape[0]
    coin = torch.rand((B,), generator=gen, device=policy.device)
    explore = explore_ok & (coin < cfg.random_action_prob)
    a_uniform = _categorical(gen, mask.to(policy.dtype))
    hand = _categorical(gen, bel_actor)
    ar = torch.arange(B, device=policy.device)
    a_policy = _categorical(gen, policy[ar, hand])
    return torch.where(explore, a_uniform, a_policy)


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


@dataclasses.dataclass(frozen=True, eq=False)
class FastCudaEngine:
    """Self-play engine whose whole subgame solve runs in one kernel
    launch per ``batch_step`` on the card (the plain version on CPU
    tensors).  Keeps the CUDA event pairs around the last
    ``SOLVE_EVENTS`` solves in ``solve_events``, so a caller can read solve
    times after a synchronise."""

    SOLVE_EVENTS = 256

    cfg: RecursiveSolvingParams
    lane_block: int = 8
    net_compute_dtype: torch.dtype = torch.float32
    solve_events: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(
            maxlen=FastCudaEngine.SOLVE_EVENTS))

    def __post_init__(self):
        sub = self.cfg.subgame_params
        if sub.max_depth != 2:
            raise ValueError("FastCudaEngine runs depth-2 subgames (CFR or "
                             f"fictitious play), not depth {sub.max_depth}")

    def solve(self, eps: EpisodeState, t_stop: torch.Tensor, net):
        B = eps.root_bid.shape[0]
        return grid2p.solve(
            self.cfg.game, self.cfg.subgame_params, eps.root_bid,
            eps.root_player, eps.beliefs, t_stop, net,
            self.net_compute_dtype,
            # Largest block that divides B (the kernel needs B % LB == 0).
            lane_block=math.gcd(self.lane_block, B),
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
