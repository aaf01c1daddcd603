"""Fixed-seed replication of the reference ``RlRunner``'s episodes, the
counterpart of ``rebel_tpu/selfplay/replicate.py``.

Drives the batch-first solver (:mod:`rebel_tpu_torch.solving.grid2`, one
subgame at a time, float64 with the win probabilities rounded through
float32 as the C++ computes them) with the reference's own random stream
(:class:`~rebel_tpu_torch.selfplay.refrng.ReferenceRng`), drawing in the
order of ``RlRunner::step``, ``sample_state_to_leaf`` and
``sample_state_single`` (recursive_solving.cc:160-275).  The training
examples it emits (queries and counterfactual values) then replicate the
reference's stream.  Sequential by construction: it exists to check
parity.  It runs on the card unless given another ``device`` (the
tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION
from rebel_tpu_torch.selfplay.refrng import ReferenceRng
from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
from rebel_tpu_torch.solving.core import REACH_EPS_F64, RootCtx
from rebel_tpu_torch.solving.grid2 import Grid2Solver
from rebel_tpu_torch.solving.queries import get_query


def _normalize_safe(x: np.ndarray, eps: float = REACH_EPS_F64) -> np.ndarray:
    x = x + eps
    return x / x.sum()


@dataclasses.dataclass
class ReplicatedExample:
    query: np.ndarray  # [Q] float32
    values: np.ndarray  # [H] float32


def replicate_episodes(cfg: RecursiveSolvingParams, seed: int,
                       episodes: int, value_fn=None,
                       device="cuda") -> list[ReplicatedExample]:
    """Run ``episodes`` reference-equivalent self-play episodes from
    ``std::mt19937(seed)`` and return their training examples in push
    order.  ``value_fn`` defaults to zero leaf values."""
    game = cfg.game
    sub = cfg.subgame_params
    if sub.max_depth != 2:
        raise ValueError("replicate_episodes solves depth-2 subgames")
    if value_fn is None:
        from rebel_tpu_torch.nets.value_nets import zero_value_fn

        value_fn = zero_value_fn(game)
    solver = Grid2Solver(game=game, params=sub, dtype=torch.float64,
                         value_fn=value_fn, terminal_f32_parity=True,
                         device=device)
    rng = ReferenceRng(seed)
    liar = game.liar_call
    out: list[ReplicatedExample] = []
    for _ in range(episodes):
        bid, player = INITIAL_ACTION, 0
        beliefs = np.full((2, game.num_hands), 1.0 / game.num_hands)
        while bid != liar:
            root = RootCtx.of(game, torch.tensor([bid], device=device),
                              torch.tensor([player], device=device))
            # RNG order of RlRunner::step (recursive_solving.cc:166-181).
            t = rng.uniform_int(0, sub.num_iters)
            state, (p0, p1) = solver.solve_with_snapshot(
                root, torch.as_tensor(beliefs[None], device=device),
                torch.tensor([t], device=device))
            rvm = state.root_values_means[0].cpu().numpy()
            p0, p1 = p0[0].cpu().numpy(), p1[0].cpu().numpy()

            # sample_state_to_leaf (recursive_solving.cc:192-246) /
            # sample_state_single (recursive_solving.cc:248-275).
            br_sampler = rng.uniform_int(0, 1)
            walk_beliefs = beliefs.copy()
            cur_bid, cur_player = bid, player
            for depth in range(2 if cfg.sample_leaf else 1):
                if cur_bid == liar:
                    break
                lo, hi = game.bid_range(cur_bid)
                policy = p0 if depth == 0 else p1[cur_bid]
                eps_draw = rng.uniform_float()
                if (cur_player == br_sampler
                        and eps_draw < cfg.random_action_prob):
                    action = rng.uniform_int(lo, hi - 1)
                else:
                    hand = rng.discrete(walk_beliefs[cur_player])
                    action = rng.discrete(policy[hand])
                walk_beliefs[cur_player] = _normalize_safe(
                    walk_beliefs[cur_player] * policy[:, action])
                cur_bid, cur_player = action, 1 - cur_player

            # Examples are pushed after the solve (subgame_solving.cc:
            # 471-474).
            for trav in (0, 1):
                out.append(ReplicatedExample(
                    query=get_query(game, trav, bid, player, beliefs[0],
                                    beliefs[1]),
                    values=rvm[trav].astype(np.float32)))
            bid, player = cur_bid, cur_player
            beliefs = walk_beliefs
    return out
