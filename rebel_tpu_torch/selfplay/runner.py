"""Self-play episodes and the generic engine, the counterpart of
``rebel_tpu/selfplay/runner.py``.

An engine step advances ``B`` episodes ("lanes") in lockstep: each lane
solves the depth-limited subgame at its public state, samples the next
state from the policy at a random stop iteration, and emits two training
examples (one per traverser).  Lanes that reach a terminal state restart
from the initial state.

:class:`SelfPlayEngine` does this for any ``max_depth`` with the generic
solvers of :mod:`rebel_tpu_torch.solving.solver` on the shared supertree;
the depth-2 engines of :mod:`rebel_tpu_torch.selfplay.fast_runner` are the
fast path.  Every random choice is made by a function that takes one
``torch.Generator`` (:func:`draw_stop`, ``draw_path``), apart from the
function that applies the choices (``advance``), so a test can feed the
reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice
from rebel_tpu_torch.solving.core import (
    RootCtx,
    SolverContext,
    normalize_safe,
    reach_eps,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.solver import build_solver
from rebel_tpu_torch.tree import build_supertree


@dataclasses.dataclass(frozen=True)
class RecursiveSolvingParams:
    num_dice: int = 1
    num_faces: int = 4
    subgame_params: SubgameSolvingParams = SubgameSolvingParams()
    random_action_prob: float = 1.0
    sample_leaf: bool = False

    @property
    def game(self) -> LiarsDice:
        return LiarsDice(self.num_dice, self.num_faces)


class EpisodeState(NamedTuple):
    """Per-lane public state and beliefs; lanes lead every tensor."""

    root_bid: torch.Tensor  # [B] int64, -1 = initial state
    root_player: torch.Tensor  # [B] int64
    beliefs: torch.Tensor  # [B, 2, H]

    @staticmethod
    def initial_batch(game: LiarsDice, batch: int, device="cuda",
                      dtype=torch.float32) -> "EpisodeState":
        return EpisodeState(
            root_bid=torch.full((batch,), INITIAL_ACTION, dtype=torch.long,
                                device=device),
            root_player=torch.zeros((batch,), dtype=torch.long,
                                    device=device),
            beliefs=torch.full((batch, 2, game.num_hands),
                               1.0 / game.num_hands, dtype=dtype,
                               device=device),
        )

    @staticmethod
    def initial(game: LiarsDice, device="cuda", dtype=torch.float32):
        """One lane's initial state (a batch of one)."""
        return EpisodeState.initial_batch(game, 1, device, dtype)


class StepOutput(NamedTuple):
    queries: torch.Tensor  # [B, 2, Q] training queries (traverser 0, 1)
    values: torch.Tensor  # [B, 2, H] root counterfactual values
    ended: torch.Tensor  # [B] bool: the episode ended this step


# ------------------------------------------------------------- the draws
def draw_stop(gen: torch.Generator, batch: int, num_iters: int,
              device) -> torch.Tensor:
    """Per-lane stop iteration ``t ~ U{0, ..., num_iters}``."""
    return torch.randint(0, num_iters + 1, (batch,), generator=gen,
                         device=device)


def _categorical(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row of unnormalised ``probs [N, K]``.  Rows without
    mass (a row below a lane that has already ended, whose draw is never
    used) draw uniformly instead of failing."""
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


# ----------------------------------------------------- the generic engine
@dataclasses.dataclass(frozen=True, eq=False)
class SelfPlayEngine:
    """Self-play for any ``max_depth``: every lane's subgame is a mask
    over one supertree, solved in lockstep by the generic CFR or FP solver
    with the value net at the pseudo-leaves, the lanes as the leading
    batch dimension.  ``sample_leaf`` walks the snapshot policy down to a
    leaf of the subgame; without it a lane takes one action."""

    cfg: RecursiveSolvingParams
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        game = self.cfg.game
        object.__setattr__(self, "game", game)
        object.__setattr__(self, "tree", build_supertree(
            game, self.cfg.subgame_params.max_depth))
        object.__setattr__(self, "_contexts", {})

    def context(self, device) -> SolverContext:
        """The solver context on ``device`` (built once per device)."""
        device = torch.device(device)
        if device not in self._contexts:
            self._contexts[device] = SolverContext(
                game=self.game, tree=self.tree, dtype=self.dtype,
                device=device)
        return self._contexts[device]

    def solve_with_snapshot(self, eps: EpisodeState, t_stop: torch.Tensor,
                            value_fn):
        """All ``num_iters`` iterations; returns the final solver state and
        the sampling policy ``[B, N, H, A]`` each lane had before its
        iteration ``t_stop`` (``num_iters``: the final one)."""
        ctx = self.context(eps.beliefs.device)
        params = self.cfg.subgame_params
        root = RootCtx.of(self.game, eps.root_bid, eps.root_player)
        solver = build_solver(ctx, params, value_fn)
        state = solver.init(root, eps.beliefs)
        snap = solver.sampling_strategy(state)
        take = lambda it: (t_stop == it)[:, None, None, None]
        for it in range(params.num_iters):
            snap = torch.where(take(it), solver.sampling_strategy(state),
                               snap)
            state = solver.step(state, it % 2, root)
        snap = torch.where(take(params.num_iters),
                           solver.sampling_strategy(state), snap)
        return state, snap

    def _walk(self, eps: EpisodeState, policy: torch.Tensor, choose):
        """Follow ``choose(step, actor, mask, bel_actor, policy_node)``
        from the root for ``max_depth`` steps (one without ``sample_leaf``)
        or until a leaf, with Bayes updates ``b'(h) ~ b(h) pi(a|h)`` of the
        actor's beliefs.  Returns the node reached ``[B]``, the beliefs and
        the actions ``[B, steps]``."""
        dev = eps.beliefs.device
        ctx = self.context(dev)
        tree = self.tree
        root = RootCtx.of(self.game, eps.root_bid, eps.root_player)
        amask = ctx.action_masks(root)  # [B, N, A]
        child = ctx._child_clamped
        at_end = torch.as_tensor(tree.is_leaf | tree.is_terminal, device=dev)
        eps_reach = reach_eps(eps.beliefs.dtype)
        B = eps.root_bid.shape[0]
        ar = torch.arange(B, device=dev)
        node = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        bel = eps.beliefs
        actions = []
        steps = tree.max_depth if self.cfg.sample_leaf else 1
        for k in range(steps):
            actor = (eps.root_player + ctx._depth[node]) % 2
            pol = policy[ar, node].to(bel.dtype)  # [B, H, A]
            action = choose(k, actor, amask[ar, node], bel[ar, actor], pol)
            stepped = bel.clone()
            stepped[ar, actor] = normalize_safe(
                bel[ar, actor] * pol[ar, :, action], eps_reach)
            bel = torch.where(done[:, None, None], bel, stepped)
            node = torch.where(done, node, child[node, action])
            done = done | at_end[node]
            actions.append(action)
        return node, bel, torch.stack(actions, dim=1)

    def draw_path(self, gen: torch.Generator, eps: EpisodeState,
                  policy: torch.Tensor) -> torch.Tensor:
        """``[B, steps]`` actions of the walk: a best-response player per
        lane explores uniformly with ``random_action_prob``, otherwise the
        actor draws a hand from its beliefs and an action from
        ``policy[node, hand]``.  Steps after a lane's leaf are unused."""
        B = eps.root_bid.shape[0]
        br_sampler = torch.randint(0, 2, (B,), generator=gen,
                                   device=eps.beliefs.device)

        def choose(k, actor, mask, bel_actor, pol):
            return _sample_action(gen, self.cfg, pol, mask, bel_actor,
                                  actor == br_sampler)

        return self._walk(eps, policy, choose)[2]

    def advance(self, eps: EpisodeState, policy: torch.Tensor,
                values: torch.Tensor, actions: torch.Tensor):
        """Walk every lane along ``actions``; lanes that end restart from
        the initial state.  Returns the new state and the step's training
        examples (the root queries of the OLD state for traverser 0 and 1,
        and ``values``)."""
        dev = eps.beliefs.device
        ctx = self.context(dev)
        tree, game = self.tree, self.game
        root = RootCtx.of(game, eps.root_bid, eps.root_player)
        queries = torch.stack(
            [ctx.root_query(eps.beliefs, t, root) for t in (0, 1)], dim=1)
        node, bel, _ = self._walk(
            eps, policy, lambda k, *_: actions[:, k])
        last_bid = torch.as_tensor(tree.last_bid.astype("int64"), device=dev)
        ended = torch.as_tensor(tree.is_terminal, device=dev)[node]
        new_player = (eps.root_player + ctx._depth[node]) % 2
        new_ep = EpisodeState(
            root_bid=torch.where(ended, INITIAL_ACTION, last_bid[node]),
            root_player=torch.where(ended, 0, new_player),
            beliefs=torch.where(ended[:, None, None], 1.0 / game.num_hands,
                                bel),
        )
        return new_ep, StepOutput(queries=queries.to(eps.beliefs.dtype),
                                  values=values, ended=ended)

    @torch.no_grad()
    def batch_step(self, eps: EpisodeState, net, gen: torch.Generator):
        """One step of all lanes.  ``net`` maps queries ``[B, L, Q]`` to
        values ``[B, L, H]`` (a :class:`~rebel_tpu_torch.nets.cfv_net.
        CFVNet` or any value function; ``None`` only for a depth that
        reaches no pseudo-leaf)."""
        B = eps.root_bid.shape[0]
        t = draw_stop(gen, B, self.cfg.subgame_params.num_iters,
                      eps.beliefs.device)
        state, snap = self.solve_with_snapshot(eps, t, net)
        actions = self.draw_path(gen, eps, snap)
        return self.advance(eps, snap, state.root_values_means, actions)
