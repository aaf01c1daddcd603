"""CFR and fictitious-play subgame solvers over any tree, in plain PyTorch.

Counterpart of ``rebel_tpu/solving/solver.py``.  One iteration is a fixed
sequence of tensor programs over ``[*b, num_nodes, num_hands,
num_actions]`` tensors (see :class:`~rebel_tpu_torch.solving.core.
SolverContext`) with the value net evaluated at the pseudo-leaves; the
iteration loop is a Python loop.  Leading batch dimensions ``[*b]`` solve
many subgames in lockstep, each with its own root context and beliefs.

State is explicit (NamedTuples); the solvers are stateless factories of
``init``/``step`` functions.  The traverser of a step is a Python int, and
so are the step counters.  :class:`SubgameSolver` is a thin stateful
wrapper for host-side use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rebel_tpu_torch.solving.core import (
    RootCtx,
    SolverContext,
    ValueFn,
    cfr_discounts,
    normalize,
    regret_eps,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams


class CFRState(NamedTuple):
    regrets: torch.Tensor  # [*b, N, H, A]
    sum_strategies: torch.Tensor  # [*b, N, H, A]
    last_strategies: torch.Tensor  # [*b, N, H, A]
    root_values_means: torch.Tensor  # [*b, 2, H]
    num_steps: tuple  # (int, int): updates made per traverser
    beliefs: torch.Tensor  # [*b, 2, H]

    # The average strategy is not kept: it always equals
    # normalize(sum_strategies) over the action mask, so it is computed on
    # demand.


class FPState(NamedTuple):
    sum_strategies: torch.Tensor  # [*b, N, H, A]
    last_strategies: torch.Tensor  # [*b, N, H, A]
    average_strategies: torch.Tensor  # [*b, N, H, A]
    root_values_means: torch.Tensor  # [*b, 2, H]
    num_strategies: int
    beliefs: torch.Tensor  # [*b, 2, H]


def _actor_rows(ctx: SolverContext, player: int, root: RootCtx):
    """``[*b, N, 1, 1]`` bool: interior nodes where ``player`` acts."""
    actor = ctx.node_player(ctx._depth, root) == player
    return (actor & ctx._interior_t)[..., None, None]


def _uniform_reach_weighted(ctx: SolverContext, uniform: torch.Tensor,
                            beliefs: torch.Tensor, root: RootCtx):
    """Initial ``sum_strategies``: the uniform strategy with each node's
    rows scaled by its actor's reach under uniform play."""
    sum_strat = uniform
    for p in (0, 1):
        reach = ctx.compute_reaches(uniform, beliefs[..., p, :], p, root)
        sum_strat = torch.where(_actor_rows(ctx, p, root),
                                uniform * reach[..., None], sum_strat)
    return sum_strat


def _update_rvm(rvm, traverser: int, root_values, alpha: float):
    rvm = rvm.clone()
    rvm[..., traverser, :] += (root_values - rvm[..., traverser, :]) * alpha
    return rvm


# =============================================================== CFR =====
class CFR:
    """Counterfactual regret minimisation with regret matching, linear or
    DCFR discounting, and reach-weighted average-strategy accumulation."""

    def __init__(self, ctx: SolverContext, params: SubgameSolvingParams,
                 value_fn: ValueFn | None = None):
        assert params.use_cfr
        self.ctx, self.params, self.value_fn = ctx, params, value_fn

    def init(self, root: RootCtx, beliefs: torch.Tensor) -> CFRState:
        ctx = self.ctx
        dt = ctx.dtype
        beliefs = beliefs.to(device=ctx.device, dtype=dt)
        uniform = ctx.uniform_strategy(ctx.action_masks(root))
        sums = _uniform_reach_weighted(ctx, uniform, beliefs, root)
        return CFRState(
            regrets=torch.zeros_like(sums),
            sum_strategies=sums,
            last_strategies=uniform.expand_as(sums),
            root_values_means=torch.zeros_like(beliefs),
            num_steps=(0, 0),
            beliefs=beliefs,
        )

    @torch.no_grad()
    def step(self, state: CFRState, traverser: int, root: RootCtx):
        """One CFR iteration for ``traverser``."""
        ctx, p = self.ctx, self.params
        dt = ctx.dtype
        amask = ctx.action_masks(root)
        last = state.last_strategies

        reach0 = ctx.compute_reaches(last, state.beliefs[..., 0, :], 0, root)
        reach1 = ctx.compute_reaches(last, state.beliefs[..., 1, :], 1, root)
        leaf_vals = ctx.all_leaf_values(reach0, reach1, traverser, root,
                                        self.value_fn)
        values, q_minus_v = ctx.backup_expected(
            leaf_vals, last, traverser, root, amask, with_regrets=True)
        regrets = state.regrets + q_minus_v

        n = float(state.num_steps[traverser])
        alpha = 2.0 / (n + 2.0) if p.linear_update else 1.0 / (n + 1.0)
        rvm = _update_rvm(state.root_values_means, traverser,
                          values[..., 0, :], alpha)

        # The uniform initial strategy counts as one strategy.
        pos_d, neg_d, strat_d = (
            x.to(ctx.device) for x in cfr_discounts(p, n + 1.0, dt))

        actor_row = _actor_rows(ctx, traverser, root)
        floored = torch.clamp(regrets, min=regret_eps(dt))
        matched = normalize(floored, amask[..., None, :])
        last = torch.where(actor_row, matched, last)

        reach_last = ctx.compute_reaches(
            last, state.beliefs[..., traverser, :], traverser, root)
        regrets = torch.where(
            actor_row, regrets * torch.where(regrets > 0, pos_d, neg_d),
            regrets)
        sum_strat = torch.where(
            actor_row,
            state.sum_strategies * strat_d + reach_last[..., None] * last,
            state.sum_strategies)
        steps = list(state.num_steps)
        steps[traverser] += 1
        return CFRState(
            regrets=regrets, sum_strategies=sum_strat, last_strategies=last,
            root_values_means=rvm, num_steps=tuple(steps),
            beliefs=state.beliefs,
        )

    def multistep(self, state: CFRState, root: RootCtx) -> CFRState:
        """``num_iters`` steps with alternating traversers."""
        for it in range(self.params.num_iters):
            state = self.step(state, it % 2, root)
        return state

    @staticmethod
    def sampling_strategy(state: CFRState) -> torch.Tensor:
        """CFR samples and propagates beliefs with the current iterate."""
        return state.last_strategies

    def average_strategy(self, state: CFRState, root: RootCtx):
        return normalize(state.sum_strategies,
                         self.ctx.action_masks(root)[..., None, :])


# ================================================================ FP =====
class FP:
    """Fictitious play: a full best response against the average
    strategy."""

    def __init__(self, ctx: SolverContext, params: SubgameSolvingParams,
                 value_fn: ValueFn | None = None):
        assert not params.use_cfr
        self.ctx, self.params, self.value_fn = ctx, params, value_fn

    def init(self, root: RootCtx, beliefs: torch.Tensor) -> FPState:
        ctx = self.ctx
        beliefs = beliefs.to(device=ctx.device, dtype=ctx.dtype)
        uniform = ctx.uniform_strategy(ctx.action_masks(root))
        sums = _uniform_reach_weighted(ctx, uniform, beliefs, root)
        uniform = uniform.expand_as(sums)
        return FPState(
            sum_strategies=sums,
            last_strategies=uniform,
            average_strategies=uniform,
            root_values_means=torch.zeros_like(beliefs),
            num_strategies=0,
            beliefs=beliefs,
        )

    def compute_br(self, state: FPState, traverser: int, root: RootCtx):
        """Best response to the average strategy: reaches and leaf values
        under the average, then a max/sum backup."""
        ctx = self.ctx
        avg = state.average_strategies
        reach0 = ctx.compute_reaches(avg, state.beliefs[..., 0, :], 0, root)
        reach1 = ctx.compute_reaches(avg, state.beliefs[..., 1, :], 1, root)
        leaf_vals = ctx.all_leaf_values(reach0, reach1, traverser, root,
                                        self.value_fn)
        return ctx.backup_best_response(leaf_vals, traverser, root,
                                        ctx.action_masks(root))

    @torch.no_grad()
    def step(self, state: FPState, traverser: int, root: RootCtx):
        """One FP iteration for ``traverser``."""
        ctx, p = self.ctx, self.params
        amask = ctx.action_masks(root)
        values, br = self.compute_br(state, traverser, root)

        # Running mean of root values, counted in alternating updates.
        num_update = float(state.num_strategies // 2 + 1)
        alpha = (2.0 / (num_update + 1.0) if p.linear_update
                 else 1.0 / num_update)
        rvm = _update_rvm(state.root_values_means, traverser,
                          values[..., 0, :], alpha)

        # The sums take the best response weighted by the traverser's
        # reach under it, then decay when linear.
        reach_br = ctx.compute_reaches(
            br, state.beliefs[..., traverser, :], traverser, root)
        actor_row = _actor_rows(ctx, traverser, root)
        weighted_br = reach_br[..., None] * br
        sum_strat = torch.where(actor_row, state.sum_strategies + weighted_br,
                                state.sum_strategies)
        last = torch.where(actor_row, weighted_br, state.last_strategies)
        if p.linear_update:
            decay = (num_update + 1.0) / (num_update + 2.0)
            sum_strat = torch.where(actor_row, sum_strat * decay, sum_strat)

        # Average = normalised sum; optimistic adds the last response
        # once more.
        numer = sum_strat + last if p.optimistic else sum_strat
        avg = torch.where(actor_row, normalize(numer, amask[..., None, :]),
                          state.average_strategies)
        return FPState(
            sum_strategies=sum_strat, last_strategies=last,
            average_strategies=avg, root_values_means=rvm,
            num_strategies=state.num_strategies + 1, beliefs=state.beliefs,
        )

    def multistep(self, state: FPState, root: RootCtx) -> FPState:
        for it in range(self.params.num_iters):
            state = self.step(state, it % 2, root)
        return state

    @staticmethod
    def sampling_strategy(state: FPState) -> torch.Tensor:
        """FP samples and propagates beliefs with the average strategy."""
        return state.average_strategies

    def average_strategy(self, state: FPState, root: RootCtx):
        del root
        return state.average_strategies


def build_solver(ctx: SolverContext, params: SubgameSolvingParams,
                 value_fn: ValueFn | None = None):
    cls = CFR if params.use_cfr else FP
    return cls(ctx, params, value_fn)


# ==================================================== host wrapper =======
class SubgameSolver:
    """Stateful wrapper around :func:`build_solver` for host-side use."""

    def __init__(self, ctx: SolverContext, params: SubgameSolvingParams,
                 root: RootCtx, beliefs, value_fn: ValueFn | None = None):
        self.impl = build_solver(ctx, params, value_fn)
        self.ctx = ctx
        self.params = params
        self.root = root
        self.state = self.impl.init(root, torch.as_tensor(beliefs))

    def step(self, traverser: int) -> None:
        self.state = self.impl.step(self.state, traverser, self.root)

    def multistep(self) -> None:
        self.state = self.impl.multistep(self.state, self.root)

    def get_strategy(self):
        return self.impl.average_strategy(self.state, self.root)

    def get_sampling_strategy(self):
        return self.impl.sampling_strategy(self.state)

    def get_belief_propagation_strategy(self):
        return self.impl.sampling_strategy(self.state)

    def get_hand_values(self, player_id: int):
        return self.state.root_values_means[..., player_id, :]

    @property
    def tree(self):
        return self.ctx.tree
