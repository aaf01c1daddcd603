"""Shared solver scalars and helpers (the subset of
``rebel_tpu/solving/core.py`` and ``rebel_tpu/tree.py`` the depth-2 path
uses), as torch ops vectorised over leading batch dimensions."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice

# Reach / regret smoothing constants: 1e-80 in double precision, and for
# float32 the largest epsilon that is still negligible next to real
# probability mass yet clear of the float32 denormal range.
REACH_EPS_F64 = 1e-80
REGRET_EPS_F64 = 1e-80
REACH_EPS_F32 = 1e-30
REGRET_EPS_F32 = 1e-30


def reach_eps(dtype: torch.dtype) -> float:
    return REACH_EPS_F64 if dtype == torch.float64 else REACH_EPS_F32


def regret_eps(dtype: torch.dtype) -> float:
    return REGRET_EPS_F64 if dtype == torch.float64 else REGRET_EPS_F32


def root_action_mask(game: LiarsDice, bid: torch.Tensor) -> torch.Tensor:
    """``[..., A]`` legal root actions for last bids ``bid [...]``: actions
    above the bid, and no liar call as the opening move."""
    a = torch.arange(game.num_actions, device=bid.device)
    b = bid[..., None]
    return (a > b) & ((b != INITIAL_ACTION) | (a != game.liar_call))


class RootCtx(NamedTuple):
    """Root context of a batch of subgames: last bid, actor, legal mask."""

    bid: torch.Tensor  # [...] int
    player: torch.Tensor  # [...] int
    mask: torch.Tensor  # [..., A] bool

    @staticmethod
    def of(game: LiarsDice, bid: torch.Tensor, player: torch.Tensor):
        return RootCtx(bid=bid, player=player,
                       mask=root_action_mask(game, bid))


def normalize_safe(x: torch.Tensor, eps: float, dim: int = -1):
    """Epsilon-smoothed normalization: all-zero inputs become uniform."""
    x = x + eps
    return x / x.sum(dim=dim, keepdim=True)


def root_query(game: LiarsDice, beliefs: torch.Tensor, traverser,
               bid: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """``[..., query_size]`` value-net query of a public state:
    ``[player, traverser, one-hot(bid), beliefs0, beliefs1]`` with both
    belief rows epsilon-normalised.  ``beliefs [..., 2, H]``; ``traverser``
    is an int or a tensor broadcastable to ``bid``."""
    dt = beliefs.dtype
    eps = reach_eps(dt)
    a = torch.arange(game.num_actions, device=beliefs.device)
    onehot = (a == bid[..., None]).to(dt)
    trav = torch.as_tensor(traverser, device=beliefs.device)
    trav = torch.broadcast_to(trav, bid.shape).to(dt)
    return torch.cat(
        [
            player.to(dt)[..., None],
            trav[..., None],
            onehot,
            normalize_safe(beliefs[..., 0, :], eps),
            normalize_safe(beliefs[..., 1, :], eps),
        ],
        dim=-1,
    )


def cfr_discounts(p, num_strategies: float, dtype=torch.float32):
    """``(pos_d, neg_d, strat_d)`` regret/average-strategy discounts of one
    CFR update, as 0-d tensors of ``dtype``: linear CFR, or DCFR with the
    alpha >= 5 / beta <= -5 clamps, or none."""
    n = torch.tensor(num_strategies, dtype=dtype)
    one = torch.tensor(1.0, dtype=dtype)
    if p.linear_update:
        d = n / (n + 1)
        return d, d, d
    if p.dcfr:
        if p.dcfr_alpha >= 5:
            pos_d = one
        else:
            na = n**p.dcfr_alpha
            pos_d = na / (na + 1.0)
        if p.dcfr_beta <= -5:
            neg_d = torch.tensor(0.0, dtype=dtype)
        else:
            nb = n**p.dcfr_beta
            neg_d = nb / (nb + 1.0)
        strat_d = (n / (n + 1)) ** p.dcfr_gamma
        return pos_d, neg_d, strat_d
    return one, one, one
