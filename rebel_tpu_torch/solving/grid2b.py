"""Batch-last depth-2 CFR and fictitious-play solver in plain PyTorch.

Port of ``rebel_tpu/solving/grid2b.py`` (``init``/``step_cfr``/
``step_fp``/``sampling_strategy``/``average_strategy``), in float32 or
float64.  The subgame batch ``B`` is the trailing axis of
every tensor:

* root tensors    ``[H, A, B]``
* level-1 tensors ``[A1, H, A2, B]``
* beliefs/rvm     ``[2, H, B]``
* root context    ``bid/player [B]``, ``mask [A, B]``

The value net enters as ``mlp``, a callable ``x [Q, N] -> [H, N]`` with
features in rows (``None`` gives zero leaf values), so the same solver
serves the flax-numerics net and the fused kernel's numerics
(:func:`rebel_tpu_torch.solving.grid2p.kernel_mlp`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice
from rebel_tpu_torch.solving.core import (
    cfr_discounts,
    first_max,
    normalize_safe,
    reach_eps,
    regret_eps,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams

Mlp = Callable[[torch.Tensor], torch.Tensor]


class Grid2BState(NamedTuple):
    regrets0: torch.Tensor  # [H, A, B]
    sum0: torch.Tensor  # [H, A, B]
    last0: torch.Tensor  # [H, A, B]
    regrets1: torch.Tensor  # [A, H, A, B]
    sum1: torch.Tensor  # [A, H, A, B]
    last1: torch.Tensor  # [A, H, A, B]
    root_values_means: torch.Tensor  # [2, H, B]
    num_steps: tuple  # (int, int): updates made per traverser
    beliefs: torch.Tensor  # [2, H, B]


class RootCtxB(NamedTuple):
    bid: torch.Tensor  # [B] int
    player: torch.Tensor  # [B] int
    mask: torch.Tensor  # [A, B] bool

    @staticmethod
    def of(game: LiarsDice, bid: torch.Tensor, player: torch.Tensor):
        a = torch.arange(game.num_actions, device=bid.device)[:, None]
        mask = (a > bid[None, :]) & (
            (bid[None, :] != INITIAL_ACTION) | (a != game.liar_call)
        )
        return RootCtxB(bid=bid, player=player, mask=mask)


@dataclasses.dataclass(frozen=True, eq=False)
class Grid2BatchSolver:
    """Depth-2 CFR or FP over an explicit trailing batch axis."""

    game: LiarsDice
    params: SubgameSolvingParams
    dtype: torch.dtype = torch.float32
    mlp: Optional[Mlp] = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.params.max_depth != 2:
            raise ValueError("Grid2BatchSolver solves depth-2 subgames only")
        A = self.game.num_actions
        liar = self.game.liar_call
        a1g, a2g = np.meshgrid(np.arange(A), np.arange(A), indexing="ij")
        m1 = (a2g > a1g) & (a1g != liar)
        dev = torch.device(self.device)
        object.__setattr__(self, "m1", torch.as_tensor(m1, device=dev))
        object.__setattr__(
            self, "pseudo", torch.as_tensor(m1 & (a2g != liar), device=dev)
        )

    # ------------------------------------------------------------ helpers
    def _win_values(self, bids, opp_mass):
        """Payoff of challenged ``bids [..., B]`` vs opponent mass
        ``opp_mass [..., H, B]`` -> ``[..., H, B]``."""
        game = self.game
        D = game.total_num_dice
        dev = opp_mass.device
        # Hazard: a root bid of -1 (INITIAL_ACTION) reaches this line.
        # torch's ``%`` and ``//`` on tensors round toward -inf like
        # numpy/JAX (-1 % F = F-1, -1 // F = -1); those lanes are masked
        # later, but the values match the reference's all the same.
        faces = bids % game.num_faces
        quantities = 1 + torch.div(bids, game.num_faces, rounding_mode="floor")
        m = torch.as_tensor(game.matches_table, dtype=self.dtype, device=dev)
        fsel = (
            faces[..., None, :]
            == torch.arange(game.num_faces, device=dev)[:, None]
        ).to(self.dtype)  # [..., F, B]
        own = torch.einsum("hf,...fb->...hb", m, fsel)  # [..., H, B]
        levels = torch.arange(D + 1, device=dev)[:, None]
        onehot = (own[..., None, :] == levels).to(self.dtype)  # [..,H,D+1,B]
        buckets = (opp_mass[..., None, :] * onehot).sum(-3)  # [..., D+1, B]
        cum = torch.flip(torch.cumsum(torch.flip(buckets, [-2]), -2), [-2])
        left = torch.clamp(quantities[..., None, :] - own, 0, D)
        sel = (left[..., None, :] == levels).to(self.dtype)  # [..,H,D+1,B]
        p_win = (cum[..., None, :, :] * sel).sum(-2)  # [..., H, B]
        return p_win * 2 - opp_mass.sum(-2, keepdim=True)

    def _leaf_values(self, traverser: int, root: RootCtxB, beliefs, S0, S1):
        """``(val_liar1 [H, B], val2 [A1, A2, H, B])``."""
        game = self.game
        A = game.num_actions
        B = beliefs.shape[-1]
        liar = game.liar_call
        dt = self.dtype
        dev = beliefs.device
        opp = 1 - traverser
        m0 = root.mask.to(dt)  # [A, B]
        m1 = self.m1.to(dt)  # [A1, A2]

        bel_opp = beliefs[opp]  # [H, B]
        bel_trav = beliefs[traverser]
        root_owns = lambda p: (root.player == p)[None, None, :]  # [1,1,B]

        S0_t = S0.transpose(0, 1)  # [A, H, B]
        r1_o = bel_opp[None] * torch.where(root_owns(opp), S0_t, 1.0)
        r1_o = r1_o * m0[:, None, :]  # [A1, H, B]
        S1_t = S1.transpose(1, 2)  # [A1, A2, H, B]
        r2_o = r1_o[:, None] * torch.where(root_owns(opp)[None], 1.0, S1_t)
        r2_o = r2_o * m1[:, :, None, None]

        lvl1_player = (root.player + 1) % 2
        sign1 = torch.where(lvl1_player == traverser, 1.0, -1.0)[None, :]
        val_liar1 = sign1 * self._win_values(root.bid, r1_o[liar])  # [H, B]

        sign2 = torch.where(root.player == traverser, 1.0, -1.0)[None, None]
        bids2 = torch.broadcast_to(torch.arange(A, device=dev)[:, None], (A, B))
        v2_liar = sign2 * self._win_values(bids2, r2_o[:, liar])  # [A1, H, B]

        liar_col = (torch.arange(A, device=dev) == liar).to(dt)
        val2 = v2_liar[:, None] * liar_col[None, :, None, None]

        if self.mlp is not None:
            r1_t = bel_trav[None] * torch.where(root_owns(traverser), S0_t, 1.0)
            r2_t = r1_t[:, None] * torch.where(
                root_owns(traverser)[None], 1.0, S1_t
            )
            reach2_p0 = r2_t if traverser == 0 else r2_o
            reach2_p1 = r2_o if traverser == 0 else r2_t
            eps = reach_eps(dt)
            b0 = normalize_safe(reach2_p0, eps, dim=2)  # [A1, A2, H, B]
            b1 = normalize_safe(reach2_p1, eps, dim=2)
            onehot2 = torch.broadcast_to(
                torch.eye(A, dtype=dt, device=dev)[None, :, :, None],
                (A, A, A, B),
            )
            pcol = torch.broadcast_to(
                root.player.to(dt)[None, None, None, :], (A, A, 1, B)
            )
            tcol = torch.full((A, A, 1, B), float(traverser), dtype=dt,
                              device=dev)
            q = torch.cat([pcol, tcol, onehot2, b0, b1], dim=2)
            Q = q.shape[2]
            x = q.movedim(2, 0).reshape(Q, A * A * B)
            net_vals = self.mlp(x).to(dt)
            net_vals = net_vals.reshape(-1, A, A, B).movedim(0, 2)
            scale = r2_o.sum(dim=2, keepdim=True)
            val2 = val2 + torch.where(
                self.pseudo[:, :, None, None], net_vals * scale, 0.0
            )
        val2 = val2 * m1[:, :, None, None]
        return val_liar1, val2

    def _backup(self, traverser: int, root: RootCtxB, S0, S1, val_liar1,
                val2):
        liar = self.game.liar_call
        dt = self.dtype
        m0 = root.mask.to(dt)  # [A, B]
        m1 = self.m1.to(dt)  # [A1, A2]
        lvl1_is_trav = ((root.player + 1) % 2 == traverser)[None, None, :]

        q2 = val2.transpose(1, 2)  # [A1, H, A2, B]
        m1e = m1[:, None, :, None]
        v1_strat = (S1 * m1e * q2).sum(2)  # [A1, H, B]
        v1_sum = val2.sum(1)  # [A1, H, B]
        V1 = torch.where(lvl1_is_trav, v1_strat, v1_sum)
        is_liar_row = (torch.arange(m1.shape[0], device=m1.device) == liar)
        V1 = torch.where(is_liar_row[:, None, None], val_liar1[None], V1)
        root_is_trav = (root.player == traverser)[None, None, :]
        inc1 = q2 - V1[:, :, None, :]
        dR1 = torch.where(
            lvl1_is_trav[None] & (m1e > 0) & (m0[:, None, None, :] > 0),
            inc1,
            0.0,
        )
        V1_t = V1.transpose(0, 1)  # [H, A1, B]
        v0_strat = (S0 * m0[None] * V1_t).sum(1)  # [H, B]
        v0_sum = (V1 * m0[:, None, :]).sum(0)  # [H, B]
        V0 = torch.where(root_is_trav[0], v0_strat, v0_sum)
        inc0 = V1_t - V0[:, None, :]
        dR0 = torch.where(root_is_trav & (m0[None] > 0), inc0, 0.0)
        return V0, V1, dR0, dR1

    # ---------------------------------------------------------------- init
    def init(self, root: RootCtxB, beliefs: torch.Tensor) -> Grid2BState:
        """``beliefs [2, H, B]``; the initial policy is uniform over legal
        actions."""
        A = self.game.num_actions
        H, B = beliefs.shape[1], beliefs.shape[-1]
        dt = self.dtype
        m0 = root.mask.to(dt)  # [A, B]
        u0 = torch.broadcast_to(
            (m0 / torch.clamp(m0.sum(0, keepdim=True), min=1))[None],
            (H, A, B),
        )
        m1row = self.m1.to(dt)
        u1_row = m1row / torch.clamp(m1row.sum(1, keepdim=True), min=1)
        u1 = torch.broadcast_to(u1_row[:, None, :, None], (A, H, A, B))
        beliefs = beliefs.to(dt)
        root0 = (root.player == 0)[None, :]
        bel_root = torch.where(root0, beliefs[0], beliefs[1])  # [H, B]
        bel_lvl1 = torch.where(root0, beliefs[1], beliefs[0])
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=beliefs.device)
        return Grid2BState(
            regrets0=zeros(H, A, B),
            sum0=u0 * bel_root[:, None, :],
            last0=u0,
            regrets1=zeros(A, H, A, B),
            sum1=u1 * bel_lvl1[None, :, None, :],
            last1=u1,
            root_values_means=zeros(2, H, B),
            num_steps=(0, 0),
            beliefs=beliefs,
        )

    # ------------------------------------------------------------ CFR step
    def step_cfr(self, state: Grid2BState, traverser: int, root: RootCtxB):
        p = self.params
        dt = self.dtype
        m0 = root.mask.to(dt)
        m1e = self.m1.to(dt)[:, None, :, None] * m0[:, None, None, :]

        val_liar1, val2 = self._leaf_values(
            traverser, root, state.beliefs, state.last0, state.last1
        )
        V0, _, dR0, dR1 = self._backup(
            traverser, root, state.last0, state.last1, val_liar1, val2
        )
        regrets0 = state.regrets0 + dR0
        regrets1 = state.regrets1 + dR1

        n = float(state.num_steps[traverser])
        alpha = torch.tensor(
            2.0 / (n + 2.0) if p.linear_update else 1.0 / (n + 1.0), dtype=dt
        )
        rvm = state.root_values_means.clone()
        rvm[traverser] = rvm[traverser] + (V0 - rvm[traverser]) * alpha

        pos_d, neg_d, strat_d = cfr_discounts(p, n + 1.0, dt)
        pos_d, neg_d, strat_d = (x.to(rvm.device) for x in
                                 (pos_d, neg_d, strat_d))

        eps = regret_eps(dt)
        root_is_trav = (root.player == traverser)[None, None, :]
        lvl1_is_trav = ~root_is_trav

        f0 = torch.clamp(regrets0, min=eps) * m0[None]
        d0 = f0.sum(1, keepdim=True)
        matched0 = f0 / torch.where(d0 > 0, d0, 1.0)
        last0 = torch.where(root_is_trav, matched0, state.last0)
        regrets0 = torch.where(
            root_is_trav,
            regrets0 * torch.where(regrets0 > 0, pos_d, neg_d),
            regrets0,
        )
        bel_trav = state.beliefs[traverser]  # [H, B]
        sum0 = torch.where(
            root_is_trav,
            state.sum0 * strat_d + bel_trav[:, None, :] * last0,
            state.sum0,
        )

        f1 = torch.clamp(regrets1, min=eps) * (m1e > 0)
        d1 = f1.sum(2, keepdim=True)
        matched1 = f1 / torch.where(d1 > 0, d1, 1.0)
        last1 = torch.where(lvl1_is_trav[None], matched1, state.last1)
        regrets1 = torch.where(
            lvl1_is_trav[None],
            regrets1 * torch.where(regrets1 > 0, pos_d, neg_d),
            regrets1,
        )
        sum1 = torch.where(
            lvl1_is_trav[None],
            state.sum1 * strat_d + bel_trav[None, :, None, :] * last1,
            state.sum1,
        )
        steps = list(state.num_steps)
        steps[traverser] += 1
        return Grid2BState(
            regrets0=regrets0, sum0=sum0, last0=last0,
            regrets1=regrets1, sum1=sum1, last1=last1,
            root_values_means=rvm, num_steps=tuple(steps),
            beliefs=state.beliefs,
        )

    # ------------------------------------------------------------- FP step
    def step_fp(self, state: Grid2BState, traverser: int, root: RootCtxB):
        """One fictitious-play iteration: the traverser best-responds to
        the average policy (ties to the lowest action), and its
        belief-weighted response is added to its strategy sums, which
        then decay when ``linear_update``."""
        p = self.params
        dt = self.dtype
        A = self.game.num_actions
        liar = self.game.liar_call
        dev = state.beliefs.device
        m0b = root.mask  # [A, B] bool
        m0 = m0b.to(dt)
        m1b = self.m1[:, None, :, None] & m0b[:, None, None, :]  # [A1,1,A2,B]

        avg0, avg1 = self.average_strategy(state, root)
        val_liar1, val2 = self._leaf_values(
            traverser, root, state.beliefs, avg0, avg1
        )
        neg = float("-inf")
        root_is_trav = (root.player == traverser)[None, None, :]
        lvl1_is_trav = ~root_is_trav

        q2 = val2.transpose(1, 2)  # [A1, H, A2, B]
        has1 = m1b.any(2)  # [A1, 1, B]
        v1_max, br1 = first_max(torch.where(m1b, q2, neg), 2)
        v1_max = torch.where(has1, v1_max, 0.0)  # [A1, H, B]
        br1 = torch.where(has1[:, :, None, :], br1.to(dt), 0.0)
        V1 = torch.where(lvl1_is_trav, v1_max, val2.sum(1))
        is_liar_row = (torch.arange(A, device=dev) == liar)[:, None, None]
        V1 = torch.where(is_liar_row, val_liar1[None], V1)

        V1_t = V1.transpose(0, 1)  # [H, A1, B]
        v0_max, br0 = first_max(torch.where(m0b[None], V1_t, neg), 1)
        br0 = br0.to(dt)
        v0_sum = (V1 * m0[:, None, :]).sum(0)
        V0 = torch.where(root_is_trav[0], v0_max, v0_sum)

        num_update = float(sum(state.num_steps) // 2 + 1)
        alpha = torch.tensor(
            2.0 / (num_update + 1.0) if p.linear_update else 1.0 / num_update,
            dtype=dt,
        )
        rvm = state.root_values_means.clone()
        rvm[traverser] = rvm[traverser] + (V0 - rvm[traverser]) * alpha

        decay = torch.tensor(
            (num_update + 1.0) / (num_update + 2.0) if p.linear_update
            else 1.0,
            dtype=dt,
        )
        bel_trav = state.beliefs[traverser]  # [H, B]
        w0 = bel_trav[:, None, :] * br0
        sum0 = torch.where(root_is_trav, (state.sum0 + w0) * decay,
                           state.sum0)
        last0 = torch.where(root_is_trav, w0, state.last0)
        w1 = bel_trav[None, :, None, :] * br1
        sum1 = torch.where(lvl1_is_trav[None], (state.sum1 + w1) * decay,
                           state.sum1)
        last1 = torch.where(lvl1_is_trav[None], w1, state.last1)
        steps = list(state.num_steps)
        steps[traverser] += 1
        return Grid2BState(
            regrets0=state.regrets0, sum0=sum0, last0=last0,
            regrets1=state.regrets1, sum1=sum1, last1=last1,
            root_values_means=rvm, num_steps=tuple(steps),
            beliefs=state.beliefs,
        )

    # ------------------------------------------------------------- common
    def step(self, state: Grid2BState, traverser: int, root: RootCtxB):
        if self.params.use_cfr:
            return self.step_cfr(state, traverser, root)
        return self.step_fp(state, traverser, root)

    def sampling_strategy(self, state: Grid2BState, root: RootCtxB):
        """The policy episodes are sampled from: CFR's last iterate, FP's
        average."""
        if self.params.use_cfr:
            return state.last0, state.last1
        return self.average_strategy(state, root)

    def average_strategy(self, state: Grid2BState, root: RootCtxB):
        """The strategy sums (plus the last response for optimistic FP)
        normalised over legal actions; rows without mass stay zero."""
        dt = self.dtype
        m0 = root.mask.to(dt)
        m1e = self.m1.to(dt)[:, None, :, None] * m0[:, None, None, :]
        optimistic = not self.params.use_cfr and self.params.optimistic
        n0 = (state.sum0 + state.last0 if optimistic else state.sum0)
        n1 = (state.sum1 + state.last1 if optimistic else state.sum1)
        n0 = n0 * m0[None]
        n1 = n1 * (m1e > 0)
        d0 = n0.sum(1, keepdim=True)
        d1 = n1.sum(2, keepdim=True)
        return (n0 / torch.where(d0 > 0, d0, 1.0),
                n1 / torch.where(d1 > 0, d1, 1.0))
