"""Batch-first depth-2 CFR and fictitious-play solver in plain PyTorch.

Port of ``rebel_tpu/solving/grid2.py`` (``Grid2Solver``).  The depth-2
tree is laid out as dense action grids, so an iteration is rectangular
elementwise math and reductions with no gathers.  The JAX package solves
one subgame and ``vmap``s it; here the subgame batch ``B`` is an explicit
leading axis of every tensor:

* root tensors    ``[B, H, A]``   (the root actor's regrets, sums, policy)
* level-1 tensors ``[B, A, H, A]`` (the level-1 actor's, by first action)
* beliefs/rvm     ``[B, 2, H]``
* root context    ``bid/player [B]``, ``mask [B, A]``
  (:class:`~rebel_tpu_torch.solving.core.RootCtx`)

All lanes step together, so the step counts are Python ints.  The value
net enters as ``value_fn``, ``queries [N, Q] -> values [N, H]``, evaluated
on the dense ``(a1, a2)`` grid (or, with ``compact_queries``, on the
pseudo-leaf pairs only) in the solver's dtype.

With ``hands`` (a :class:`~rebel_tpu_torch.parallel.distributed.Axis` of
ranks, the JAX package's ``hands_axis``) every ``[..., H]`` tensor holds
this rank's slice of the hands (:func:`local_hands`).  The only traffic
between the ranks is a sum of the D+1 match buckets in the terminal
values, sums of the belief normalisations and the leaf scales, and a
gather of the normalised beliefs for the net's queries, whose input is
the whole belief vector.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.parallel.distributed import Axis
from rebel_tpu_torch.solving.core import (
    RootCtx,
    ValueFn,
    cfr_discounts,
    first_max,
    normalize,
    reach_eps,
    regret_eps,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams


class Grid2State(NamedTuple):
    regrets0: torch.Tensor  # [B, H, A]
    sum0: torch.Tensor  # [B, H, A]
    last0: torch.Tensor  # [B, H, A]
    regrets1: torch.Tensor  # [B, A, H, A]
    sum1: torch.Tensor  # [B, A, H, A]
    last1: torch.Tensor  # [B, A, H, A]
    root_values_means: torch.Tensor  # [B, 2, H]
    num_steps: tuple  # (int, int): updates made per traverser
    beliefs: torch.Tensor  # [B, 2, H]


def local_hands(hands, x_full: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a whole-``H`` tensor along ``dim`` (all of it
    without ``hands``)."""
    if hands is None:
        return x_full
    h_loc = x_full.shape[dim] // hands.size
    return x_full.narrow(dim, hands.index * h_loc, h_loc)


def _lanes(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-lane ``[B]`` tensor shaped to broadcast against ``ndim``
    dimensions ``[B, ...]``."""
    return x.reshape(-1, *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True, eq=False)
class Grid2Solver:
    """Depth-2 CFR (``params.use_cfr``) or fictitious play on action
    grids.  ``terminal_f32_parity`` rounds win probabilities through
    float32, as the reference C++ computes them."""

    game: LiarsDice
    params: SubgameSolvingParams
    dtype: torch.dtype = torch.float32
    value_fn: ValueFn | None = None
    terminal_f32_parity: bool = False
    # Net queries on the compact pseudo-leaf list instead of the dense
    # (a1, a2) grid: about a third of the MLP rows, the same values.
    compact_queries: bool = False
    device: str | torch.device = "cuda"
    # The ranks the hands are split over (None: all hands here).
    hands: Axis | None = None

    def __post_init__(self):
        if self.params.max_depth != 2:
            raise ValueError("Grid2Solver solves depth-2 subgames only")
        game = self.game
        A, liar = game.num_actions, game.liar_call
        a1g, a2g = np.meshgrid(np.arange(A), np.arange(A), indexing="ij")
        m1 = (a2g > a1g) & (a1g != liar)
        pseudo = m1 & (a2g != liar)
        dev = torch.device(self.device)
        object.__setattr__(self, "m1", torch.as_tensor(m1, device=dev))
        object.__setattr__(self, "pseudo",
                           torch.as_tensor(pseudo, device=dev))
        pairs = np.stack(np.nonzero(pseudo), axis=1)  # [L, 2]
        object.__setattr__(self, "pseudo_pairs",
                           torch.as_tensor(pairs, device=dev))
        object.__setattr__(
            self, "matches",
            torch.as_tensor(game.matches_table, device=dev).T.long())
        if len(pairs) and self.value_fn is None:
            raise ValueError(
                "depth-2 subgames have non-terminal leaves; provide "
                "value_fn (subgame_solving.cc:177-186)")

    # ------------------------------------------------------------ helpers
    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.hands is None else self.hands.psum_(x)

    def _gather_hands(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.hands is None else self.hands.gather(x, -1)

    def _win_values(self, bids, opp_mass):
        """``[..., H]`` payoff of the challenged ``bids [...]`` against the
        opponent's reach ``opp_mass [..., H]`` by the bucket algorithm
        (subgame_solving.cc:765-789)."""
        game = self.game
        D = game.total_num_dice
        dt = self.dtype
        dev = opp_mass.device
        # Floor semantics for a root bid of -1, as numpy's (masked later).
        faces = torch.remainder(bids, game.num_faces)
        quantities = 1 + torch.div(bids, game.num_faces,
                                   rounding_mode="floor")
        own = local_hands(self.hands, self.matches[faces])  # [..., H]
        levels = torch.arange(D + 1, device=dev)
        onehot = (own[..., None] == levels).to(dt)  # [..., H, D+1]
        buckets = self._psum((opp_mass[..., None] * onehot).sum(-2))
        cum = torch.flip(torch.cumsum(torch.flip(buckets, [-1]), -1), [-1])
        left = torch.clamp(quantities[..., None] - own, 0, D)
        sel = (left[..., None] == levels).to(dt)  # [..., H, D+1]
        p_win = (cum[..., None, :] * sel).sum(-1)
        if self.terminal_f32_parity:
            p_win = p_win.to(torch.float32).to(dt)
        return p_win * 2 - self._psum(opp_mass.sum(-1, keepdim=True))

    def _queries(self, root: RootCtx, traverser: int, b0, b1, a2):
        """``[..., Q]`` net queries at level-2 cells whose last bid is
        ``a2`` (``b0``/``b1 [..., H]``, leading ``[B, ...]``)."""
        dt = self.dtype
        shape = b0.shape[:-1]
        onehot = (torch.arange(self.game.num_actions, device=b0.device)
                  == a2[..., None]).to(dt)
        pcol = _lanes(root.player, len(shape)).to(dt).expand(*shape)
        tcol = torch.full(shape, float(traverser), dtype=dt,
                          device=b0.device)
        return torch.cat([pcol[..., None], tcol[..., None],
                          onehot.expand(*shape, -1), b0, b1], dim=-1)

    def _leaf_values(self, traverser: int, root: RootCtx, beliefs, S0, S1):
        """``(val_liar1 [B, H], val2 [B, A1, A2, H])`` under strategies
        ``(S0, S1)`` for ``traverser``; invalid cells are 0."""
        game = self.game
        A = game.num_actions
        liar = game.liar_call
        dt = self.dtype
        dev = beliefs.device
        opp = 1 - traverser
        m0 = root.mask.to(dt)  # [B, A]
        m1 = self.m1.to(dt)  # [A1, A2]
        root_is = lambda p, nd: _lanes(root.player == p, nd)

        S0_t = S0.transpose(1, 2)  # [B, A, H]
        S1_t = S1.transpose(2, 3)  # [B, A1, A2, H]
        r1_o = beliefs[:, opp, None, :] * torch.where(
            root_is(opp, 3), S0_t, 1.0)
        r1_o = r1_o * m0[:, :, None]  # [B, A1, H]
        r2_o = r1_o[:, :, None, :] * torch.where(root_is(opp, 4), 1.0, S1_t)
        r2_o = r2_o * m1[None, :, :, None]  # [B, A1, A2, H]

        # The level-1 liar call challenges the root bid; its actor is the
        # non-root player.  Level-2 liar calls challenge a1; the actor
        # there is the root player.
        sign1 = torch.where((root.player + 1) % 2 == traverser, 1.0, -1.0)
        val_liar1 = sign1.to(dt)[:, None] * self._win_values(
            root.bid, r1_o[:, liar])  # [B, H]
        sign2 = torch.where(root.player == traverser, 1.0, -1.0).to(dt)
        bids2 = torch.arange(A, device=dev).expand(root.bid.shape[0], A)
        v2_liar = sign2[:, None, None] * self._win_values(
            bids2, r2_o[:, :, liar])  # [B, A1, H]

        liar_col = (torch.arange(A, device=dev) == liar).to(dt)
        val2 = v2_liar[:, :, None, :] * liar_col[None, None, :, None]
        if len(self.pseudo_pairs):
            r1_t = beliefs[:, traverser, None, :] * torch.where(
                root_is(traverser, 3), S0_t, 1.0)
            r2_t = r1_t[:, :, None, :] * torch.where(
                root_is(traverser, 4), 1.0, S1_t)
            reach2_p0 = r2_t if traverser == 0 else r2_o
            reach2_p1 = r2_o if traverser == 0 else r2_t
            eps = reach_eps(dt)

            def norm(x):
                """Normalised over all hands, then gathered whole: the
                query holds the whole belief vector."""
                x = x + eps
                return self._gather_hands(
                    x / self._psum(x.sum(-1, keepdim=True)))

            B = beliefs.shape[0]
            if self.compact_queries:
                i1, i2 = self.pseudo_pairs.unbind(1)
                q = self._queries(root, traverser,
                                  norm(reach2_p0[:, i1, i2]),
                                  norm(reach2_p1[:, i1, i2]),
                                  i2.expand(B, -1))  # [B, L, Q]
                net_vals = self.value_fn(q.reshape(-1, q.shape[-1]))
                net_vals = local_hands(self.hands, net_vals.to(dt)).reshape(
                    B, len(i1), -1)
                scale = self._psum(r2_o[:, i1, i2].sum(-1, keepdim=True))
                val2 = val2.clone()
                val2[:, i1, i2] = net_vals * scale
            else:
                a2 = torch.arange(A, device=dev).expand(B, A, A)
                q = self._queries(root, traverser, norm(reach2_p0),
                                  norm(reach2_p1), a2)  # [B, A1, A2, Q]
                net_vals = self.value_fn(q.reshape(-1, q.shape[-1]))
                net_vals = local_hands(self.hands, net_vals.to(dt)).reshape(
                    B, A, A, -1)
                scale = self._psum(r2_o.sum(-1, keepdim=True))
                val2 = val2 + torch.where(self.pseudo[None, :, :, None],
                                          net_vals * scale, 0.0)
        val2 = val2 * m1[None, :, :, None]
        return val_liar1, val2

    def _backup(self, traverser: int, root: RootCtx, S0, S1, val_liar1,
                val2, with_regrets: bool):
        """``(V0 [B, H], V1 [B, A, H], (dR0, dR1) or None)``."""
        liar = self.game.liar_call
        m0 = root.mask  # [B, A]
        m1 = self.m1
        lvl1_is_trav = _lanes((root.player + 1) % 2 == traverser, 3)

        q2 = val2.transpose(2, 3)  # [B, A1, H, A2]
        v1_strat = (S1 * m1[None, :, None, :] * q2).sum(-1)  # [B, A1, H]
        v1_sum = val2.sum(2)  # [B, A1, H]
        V1 = torch.where(lvl1_is_trav, v1_strat, v1_sum)
        is_liar_row = (torch.arange(m1.shape[0], device=m1.device)
                       == liar)[None, :, None]
        V1 = torch.where(is_liar_row, val_liar1[:, None, :], V1)
        dR = None
        root_is_trav = _lanes(root.player == traverser, 3)
        V1_t = V1.transpose(1, 2)  # [B, H, A]
        v0_strat = (S0 * m0[:, None, :] * V1_t).sum(-1)  # [B, H]
        v0_sum = (V1 * m0[:, :, None]).sum(1)
        V0 = torch.where(root_is_trav[:, :, 0], v0_strat, v0_sum)
        if with_regrets:
            inc1 = q2 - V1[..., None]  # [B, A1, H, A2]
            dR1 = torch.where(
                lvl1_is_trav[..., None] & m1[None, :, None, :]
                & m0[:, :, None, None], inc1, 0.0)
            inc0 = V1_t - V0[..., None]  # [B, H, A]
            dR0 = torch.where(root_is_trav & m0[:, None, :], inc0, 0.0)
            dR = (dR0, dR1)
        return V0, V1, dR

    def _m1_eff(self, root: RootCtx) -> torch.Tensor:
        """``[B, A1, 1, A2]`` legal level-1 actions: under a legal root
        action (the generic solver zeroes the rows of root-masked
        level-1 nodes too)."""
        return self.m1[None, :, None, :] & root.mask[:, :, None, None]

    # ---------------------------------------------------------------- init
    def init(self, root: RootCtx, beliefs: torch.Tensor) -> Grid2State:
        """``beliefs [B, 2, H]``; the initial policy is uniform over legal
        actions, and the strategy sums start at it weighted by each
        actor's beliefs (subgame_solving.cc:125-149)."""
        A = self.game.num_actions
        B, H = beliefs.shape[0], beliefs.shape[-1]
        dt = self.dtype
        m0 = root.mask
        u0 = normalize(m0.to(dt), m0).expand(H, B, A).transpose(0, 1)
        u1 = normalize(self.m1.to(dt), self.m1)[None, :, None, :].expand(
            B, A, H, A)
        beliefs = beliefs.to(dt)
        lanes = torch.arange(B, device=beliefs.device)
        bel_root = beliefs[lanes, root.player]  # [B, H]
        bel_lvl1 = beliefs[lanes, (root.player + 1) % 2]
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=beliefs.device)
        return Grid2State(
            regrets0=zeros(B, H, A),
            sum0=u0 * bel_root[:, :, None],
            last0=u0,
            regrets1=zeros(B, A, H, A),
            sum1=u1 * bel_lvl1[:, None, :, None],
            last1=u1,
            root_values_means=zeros(B, 2, H),
            num_steps=(0, 0),
            beliefs=beliefs,
        )

    # ------------------------------------------------------------ CFR step
    def step_cfr(self, state: Grid2State, traverser: int, root: RootCtx):
        p = self.params
        dt = self.dtype
        m0 = root.mask

        val_liar1, val2 = self._leaf_values(
            traverser, root, state.beliefs, state.last0, state.last1)
        V0, _, (dR0, dR1) = self._backup(
            traverser, root, state.last0, state.last1, val_liar1, val2,
            True)
        regrets0 = state.regrets0 + dR0
        regrets1 = state.regrets1 + dR1

        n = float(state.num_steps[traverser])
        alpha = 2.0 / (n + 2.0) if p.linear_update else 1.0 / (n + 1.0)
        rvm = state.root_values_means.clone()
        rvm[:, traverser] = rvm[:, traverser] + (
            V0 - rvm[:, traverser]) * alpha

        dev = rvm.device
        pos_d, neg_d, strat_d = (x.to(dev) for x in cfr_discounts(
            p, n + 1.0, dt))
        eps = regret_eps(dt)
        root_is_trav = _lanes(root.player == traverser, 3)
        lvl1_is_trav = ~root_is_trav
        bel_trav = state.beliefs[:, traverser]  # [B, H]

        matched0 = normalize(torch.clamp(regrets0, min=eps),
                             m0[:, None, :])
        last0 = torch.where(root_is_trav, matched0, state.last0)
        regrets0 = torch.where(
            root_is_trav,
            regrets0 * torch.where(regrets0 > 0, pos_d, neg_d), regrets0)
        sum0 = torch.where(
            root_is_trav, state.sum0 * strat_d + bel_trav[:, :, None] * last0,
            state.sum0)

        matched1 = normalize(torch.clamp(regrets1, min=eps),
                             self._m1_eff(root))
        lvl1 = lvl1_is_trav[..., None]
        last1 = torch.where(lvl1, matched1, state.last1)
        regrets1 = torch.where(
            lvl1, regrets1 * torch.where(regrets1 > 0, pos_d, neg_d),
            regrets1)
        sum1 = torch.where(
            lvl1, state.sum1 * strat_d + bel_trav[:, None, :, None] * last1,
            state.sum1)
        steps = list(state.num_steps)
        steps[traverser] += 1
        return Grid2State(regrets0, sum0, last0, regrets1, sum1, last1, rvm,
                          tuple(steps), state.beliefs)

    # ------------------------------------------------------------- FP step
    def step_fp(self, state: Grid2State, traverser: int, root: RootCtx):
        """The traverser best-responds to the average policy (optimistic
        when configured, subgame_solving.cc:452-459; ties to the lowest
        action, subgame_solving.cc:316-358), and its belief-weighted
        response joins its strategy sums, which decay when
        ``linear_update``."""
        p = self.params
        dt = self.dtype
        A = self.game.num_actions
        liar = self.game.liar_call
        m0 = root.mask
        m1_eff = self._m1_eff(root)  # [B, A1, 1, A2]

        avg0, avg1 = self.average_strategy(state, root)
        val_liar1, val2 = self._leaf_values(
            traverser, root, state.beliefs, avg0, avg1)
        neg = float("-inf")
        root_is_trav = _lanes(root.player == traverser, 3)
        lvl1_is_trav = ~root_is_trav

        q2 = val2.transpose(2, 3)  # [B, A1, H, A2]
        has1 = m1_eff.any(-1)  # [B, A1, 1]
        v1_max, br1 = first_max(torch.where(m1_eff, q2, neg), -1)
        v1_max = torch.where(has1, v1_max, 0.0)  # [B, A1, H]
        br1 = torch.where(has1[..., None], br1.to(dt), 0.0)
        V1 = torch.where(lvl1_is_trav, v1_max, val2.sum(2))
        is_liar_row = (torch.arange(A, device=m0.device) == liar)[
            None, :, None]
        V1 = torch.where(is_liar_row, val_liar1[:, None, :], V1)

        V1_t = V1.transpose(1, 2)  # [B, H, A]
        v0_max, br0 = first_max(torch.where(m0[:, None, :], V1_t, neg), -1)
        br0 = br0.to(dt)
        v0_sum = torch.where(m0[:, :, None], V1, 0.0).sum(1)
        V0 = torch.where(root_is_trav[:, :, 0], v0_max, v0_sum)

        num_update = float(sum(state.num_steps) // 2 + 1)
        alpha = (2.0 / (num_update + 1.0) if p.linear_update
                 else 1.0 / num_update)
        rvm = state.root_values_means.clone()
        rvm[:, traverser] = rvm[:, traverser] + (
            V0 - rvm[:, traverser]) * alpha
        decay = ((num_update + 1.0) / (num_update + 2.0)
                 if p.linear_update else 1.0)

        bel_trav = state.beliefs[:, traverser]  # [B, H]
        w0 = bel_trav[:, :, None] * br0
        sum0 = torch.where(root_is_trav, (state.sum0 + w0) * decay,
                           state.sum0)
        last0 = torch.where(root_is_trav, w0, state.last0)
        w1 = bel_trav[:, None, :, None] * br1
        lvl1 = lvl1_is_trav[..., None]
        sum1 = torch.where(lvl1, (state.sum1 + w1) * decay, state.sum1)
        last1 = torch.where(lvl1, w1, state.last1)
        steps = list(state.num_steps)
        steps[traverser] += 1
        return Grid2State(state.regrets0, sum0, last0, state.regrets1, sum1,
                          last1, rvm, tuple(steps), state.beliefs)

    # ------------------------------------------------------------- common
    def step(self, state: Grid2State, traverser: int, root: RootCtx):
        if self.params.use_cfr:
            return self.step_cfr(state, traverser, root)
        return self.step_fp(state, traverser, root)

    def multistep(self, state: Grid2State, root: RootCtx) -> Grid2State:
        for it in range(self.params.num_iters):
            state = self.step(state, it % 2, root)
        return state

    def sampling_strategy(self, state: Grid2State, root: RootCtx):
        """``(policy0 [B, H, A], policy1 [B, A, H, A])``: CFR's current
        iterate, FP's average (subgame_solving.cc:682-688)."""
        if self.params.use_cfr:
            return state.last0, state.last1
        return self.average_strategy(state, root)

    def average_strategy(self, state: Grid2State, root: RootCtx):
        """The strategy sums (plus the last response for optimistic FP)
        normalised over legal actions; rows without mass stay zero."""
        optimistic = not self.params.use_cfr and self.params.optimistic
        n0 = state.sum0 + state.last0 if optimistic else state.sum0
        n1 = state.sum1 + state.last1 if optimistic else state.sum1
        return (normalize(n0, root.mask[:, None, :]),
                normalize(n1, self._m1_eff(root)))

    @torch.no_grad()
    def solve_with_snapshot(self, root: RootCtx, beliefs: torch.Tensor,
                            t_stop: torch.Tensor):
        """All ``num_iters`` iterations with each lane's sampling policy
        taken at its stop iteration ``t_stop [B]`` (before that
        iteration's update; ``num_iters`` takes the final policy).
        Returns ``(state, (snap0 [B, H, A], snap1 [B, A, H, A]))``."""
        state = self.init(root, beliefs)
        s0, s1 = self.sampling_strategy(state, root)
        for it in range(self.params.num_iters):
            take = t_stop == it
            c0, c1 = self.sampling_strategy(state, root)
            s0 = torch.where(_lanes(take, 3), c0, s0)
            s1 = torch.where(_lanes(take, 4), c1, s1)
            state = self.step(state, it % 2, root)
        take = t_stop == self.params.num_iters
        f0, f1 = self.sampling_strategy(state, root)
        s0 = torch.where(_lanes(take, 3), f0, s0)
        s1 = torch.where(_lanes(take, 4), f1, s1)
        return state, (s0, s1)
