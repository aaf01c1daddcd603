"""Shared tensor machinery of subgame solving, the counterpart of
``rebel_tpu/solving/core.py``: the solver scalars and the root context of
the depth-2 path, and :class:`SolverContext`, which propagates reaches,
fills terminal and value-net leaf values and backs values up over any
tree of :mod:`rebel_tpu_torch.tree`.

Everything is plain torch ops with an explicit device and dtype.  Each
depth level of a tree is one gather over a contiguous node slice (BFS
order), and the per-level loop is a Python loop.  Every method takes any
number of leading batch dimensions ``[*b]``: a root context, beliefs and
strategies may each carry them or not, and they broadcast.  A node's
actor follows from depth parity and the root's player, so one context
serves subgames rooted at either player; nodes that a concrete root masks
out of a supertree carry zero reach and masked strategies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice
from rebel_tpu_torch.tree import TreeSpec

# A value net: maps queries [..., L, query_size] -> values [..., L, H].
ValueFn = Callable[[torch.Tensor], torch.Tensor]

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

    @staticmethod
    def concrete(tree: TreeSpec, device="cuda") -> "RootCtx":
        """The static root context of a concretely rooted tree."""
        assert not tree.is_supertree
        return RootCtx(
            bid=torch.tensor(tree.root_bid, device=device),
            player=torch.tensor(tree.root_player, device=device),
            mask=torch.as_tensor(tree.action_mask[0], device=device),
        )


def broadcast_shapes(*shapes) -> torch.Size:
    """``torch.broadcast_shapes`` for concrete shapes, without its
    symbolic-shape machinery (a tenth of a solver step's host time on
    small trees)."""
    return torch.Size(np.broadcast_shapes(*shapes))


def ordered_sum(x: torch.Tensor, dim: int, keepdim: bool = False):
    """Sum along a short axis, adding the entries one after another in
    index order.  ``Tensor.sum`` reduces in blocks whose order depends on
    the backend, and fictitious play's best responses sit on exact ties
    between symmetric actions, which another rounding breaks another way:
    with this order the float64 solvers reproduce the golden fixtures bit
    for bit."""
    parts = x.unbind(dim)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.unsqueeze(dim) if keepdim else total


def normalize(x: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Masked normalization: rows without mass (masked-out nodes) become
    zero, not NaN."""
    x = torch.where(mask, x, 0.0)
    s = ordered_sum(x, dim, keepdim=True)
    return x / torch.where(s > 0, s, 1.0)


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


def first_max(masked: torch.Tensor, dim: int):
    """``(max, bool one-hot of its first occurrence)`` along ``dim``."""
    vmax = masked.amax(dim, keepdim=True)
    eq = masked == vmax
    return vmax.squeeze(dim), eq & (eq.cumsum(dim) == 1)


@dataclasses.dataclass(frozen=True, eq=False)
class SolverContext:
    """Per-(game, tree, dtype, device) constants of the solver programs.

    ``terminal_f32_parity`` rounds win probabilities through float32, as
    the C++ implementation the golden fixtures come from does; it only
    means something with ``dtype=torch.float64``."""

    game: LiarsDice
    tree: TreeSpec
    dtype: torch.dtype = torch.float32
    device: str | torch.device = "cuda"
    terminal_f32_parity: bool = False

    @property
    def N(self) -> int:
        return self.tree.num_nodes

    @property
    def A(self) -> int:
        return self.game.num_actions

    @property
    def H(self) -> int:
        return self.game.num_hands

    def __post_init__(self):
        t = self.tree
        dev = torch.device(self.device)
        A = self.game.num_actions
        put = lambda name, x: object.__setattr__(
            self, name, torch.as_tensor(np.asarray(x), device=dev))
        put("_depth", t.depth.astype(np.int64))
        put("_anc1", t.anc1_action.astype(np.int64))
        put("_action_mask", t.action_mask)
        put("_is_root", np.arange(t.num_nodes) == 0)
        put("_is_leaf", t.is_leaf)
        put("_interior_t", t.num_children > 0)
        put("_child_clamped", np.maximum(t.child_index, 0).astype(np.int64))
        tids = t.terminal_ids.astype(np.int64)
        pids = t.pseudo_leaf_ids.astype(np.int64)
        put("_tids", tids)
        put("_pids", pids)
        put("_term_depth", t.depth[tids].astype(np.int64))
        put("_term_challenged", t.challenged_bid[tids].astype(np.int64))
        put("_leaf_depth", t.depth[pids].astype(np.int64))
        put("_leaf_onehot",
            np.arange(A)[None, :] == t.last_bid[pids][:, None])
        put("_matches_t", self.game.matches_table.T.astype(np.int64))
        object.__setattr__(self, "_interior", t.num_children > 0)
        # Per level d >= 1: the parents' positions inside level d - 1 and
        # the rows (parent * A + bid) of the action-major strategy table.
        par_local, edge = [None], [None]
        for d, (ls, le) in enumerate(t.level_slices):
            if d == 0:
                continue
            par = t.parent[ls:le].astype(np.int64)
            par_local.append(torch.as_tensor(
                par - t.level_slices[d - 1][0], device=dev))
            edge.append(torch.as_tensor(
                par * A + t.last_bid[ls:le].astype(np.int64), device=dev))
        object.__setattr__(self, "_par_local", par_local)
        object.__setattr__(self, "_edge", edge)

    # --------------------------------------------------------------- masks
    def node_valid(self, root: RootCtx) -> torch.Tensor:
        """``[*b, N]`` bool: nodes reachable under the root's legal
        actions."""
        return self._is_root | root.mask[..., self._anc1]

    def action_masks(self, root: RootCtx) -> torch.Tensor:
        """``[*b, N, A]`` bool: legal actions per node under this root."""
        amask = self._action_mask & self.node_valid(root)[..., None]
        return torch.where(self._is_root[:, None], root.mask[..., None, :],
                           amask)

    def node_player(self, depth, root: RootCtx) -> torch.Tensor:
        """Actor at ``depth`` (an int: ``[*b]``; a tensor ``[n]``:
        ``[*b, n]``); players alternate from the root."""
        if isinstance(depth, int):
            return (root.player + depth) % 2
        return (root.player[..., None] + depth) % 2

    # ------------------------------------------------------------ strategy
    def uniform_strategy(self, amask: torch.Tensor) -> torch.Tensor:
        """``[*b, N, H, A]`` uniform over legal actions."""
        u = normalize(amask.to(self.dtype), amask)
        return u[..., None, :].expand(*u.shape[:-1], self.H, self.A)

    # -------------------------------------------------------------- reaches
    def compute_reaches(self, strategy: torch.Tensor,
                        beliefs_p: torch.Tensor, player: int,
                        root: RootCtx) -> torch.Tensor:
        """``[*b, N, H]``: P(root -> node, hand) for ``player``.
        Descending the tree, multiply by the acting player's strategy
        ``[*b, N, H, A]`` on the edges ``player`` owns, and copy on the
        others.  ``beliefs_p [*b, H]``."""
        batch = broadcast_shapes(
            strategy.shape[:-3], beliefs_p.shape[:-1], root.player.shape)
        # [*b, N * A, H]: row n * A + a holds strategy[n, :, a].
        sT = strategy.transpose(-1, -2).flatten(-3, -2)
        levels = [beliefs_p.to(self.dtype).expand(*batch, self.H)
                  .unsqueeze(-2)]
        for d in range(1, len(self.tree.level_slices)):
            pr = levels[-1][..., self._par_local[d], :]  # [*b, n, H]
            w = sT[..., self._edge[d], :]
            owns = (self.node_player(d - 1, root) == player)[..., None, None]
            levels.append(torch.where(owns, pr * w, pr).expand(
                *batch, -1, self.H))
        return torch.cat(levels, dim=-2)

    # -------------------------------------------------------- leaf values
    def terminal_values(self, opp_reach: torch.Tensor, traverser: int,
                        root: RootCtx) -> torch.Tensor:
        """``[*b, T, H]`` traverser values at the static terminal set.

        The opponent's reach mass ``opp_reach [*b, N, H]`` is bucketed by
        match count (one small product), the buckets are suffix-summed,
        and ``quantity - own_matches`` is looked up: O(H D) per terminal
        instead of the O(H^2) pairing.  The payoff is
        ``2 P(win) - sum(opp_reach)``, with the sign flipped when the
        traverser is the liar-caller."""
        game = self.game
        dt = self.dtype
        dev = opp_reach.device
        if self._tids.numel() == 0:
            return opp_reach.new_zeros((*opp_reach.shape[:-2], 0, self.H))
        D = game.total_num_dice
        # The challenged bid is the terminal's parent's last bid; for a
        # liar call directly below a (super)tree root that is the runtime
        # root bid, not the tree's constant.  A root bid of -1 only
        # reaches masked lanes; % and floor division round toward -inf.
        bids = torch.where(self._term_depth == 1, root.bid[..., None],
                           self._term_challenged)  # [*b, T]
        faces = bids % game.num_faces
        quantities = 1 + torch.div(bids, game.num_faces,
                                   rounding_mode="floor")
        own = self._matches_t[faces]  # [*b, T, H]
        levels = torch.arange(D + 1, device=dev)
        onehot = (own[..., None] == levels).to(dt)  # [*b, T, H, D+1]
        r = opp_reach[..., self._tids, :]  # [*b, T, H]
        buckets = ordered_sum(r[..., None] * onehot, -2)  # [*b, T, D+1]
        # Suffix sums, accumulated from the last bucket down (a scan on
        # the card would add in another order; see ordered_sum).
        parts = list(buckets.unbind(-1))
        for j in range(D - 1, -1, -1):
            parts[j] = parts[j] + parts[j + 1]
        cum = torch.stack(parts, dim=-1)
        left = torch.clamp(quantities[..., None] - own, 0, D)
        batch = broadcast_shapes(cum.shape[:-1], left.shape[:-1])
        p_win = torch.gather(cum.expand(*batch, D + 1), -1,
                             left.expand(*batch, self.H))
        if self.terminal_f32_parity:
            p_win = p_win.float().to(dt)
        v = p_win * 2 - ordered_sum(r, -1, keepdim=True)
        term_player = self.node_player(self._term_depth, root)
        sign = torch.where(term_player == traverser, 1.0, -1.0).to(dt)
        return v * sign[..., None]

    def leaf_queries(self, reach0: torch.Tensor, reach1: torch.Tensor,
                     traverser: int, root: RootCtx) -> torch.Tensor:
        """``[*b, L, query_size]`` value-net queries at the static
        pseudo-leaf set: ``[node_player, traverser, one_hot(last_bid),
        normalize_safe(reach0), normalize_safe(reach1)]``."""
        dt = self.dtype
        eps = reach_eps(dt)
        b0 = normalize_safe(reach0[..., self._pids, :].to(dt), eps)
        b1 = normalize_safe(reach1[..., self._pids, :].to(dt), eps)
        batch = b0.shape[:-1]  # [*b, L]
        player = self.node_player(self._leaf_depth, root).to(dt)
        return torch.cat([
            player.expand(batch)[..., None],
            torch.full((*batch, 1), float(traverser), dtype=dt,
                       device=b0.device),
            self._leaf_onehot.to(dt).expand(*batch, self.A),
            b0, b1,
        ], dim=-1)

    def root_query(self, beliefs: torch.Tensor, traverser,
                   root: RootCtx) -> torch.Tensor:
        """``[*b, query_size]``: the training-example query at the
        subgame root."""
        return root_query(self.game, beliefs.to(self.dtype), traverser,
                          root.bid, root.player)

    def all_leaf_values(self, reach0: torch.Tensor, reach1: torch.Tensor,
                        traverser: int, root: RootCtx,
                        value_fn: ValueFn | None) -> torch.Tensor:
        """``[*b, N, H]`` with terminal and pseudo-leaf values filled and
        zeros elsewhere.  Pseudo-leaf net values are scaled by the
        opponent's total reach mass, which restores their counterfactual
        magnitude."""
        opp_reach = reach1 if traverser == 0 else reach0
        values = torch.zeros_like(opp_reach, dtype=self.dtype)
        if self._tids.numel():
            values[..., self._tids, :] = self.terminal_values(
                opp_reach, traverser, root)
        if self._pids.numel():
            if value_fn is None:
                raise ValueError(
                    "tree has non-terminal leaves but no value net; either "
                    "provide value_fn or increase max_depth"
                )
            queries = self.leaf_queries(reach0, reach1, traverser, root)
            net_vals = value_fn(queries).to(self.dtype)  # [*b, L, H]
            scale = opp_reach[..., self._pids, :].sum(-1, keepdim=True)
            values[..., self._pids, :] = net_vals * scale
        return values

    # --------------------------------------------------------------- backup
    def _levels_bottom_up(self):
        """``(d, ls, le)`` of every level that holds an interior node,
        deepest first."""
        slices = self.tree.level_slices
        for d in reversed(range(len(slices) - 1)):
            ls, le = slices[d]
            if self._interior[ls:le].any():
                yield d, ls, le

    def backup_expected(self, leaf_values: torch.Tensor,
                        strategy: torch.Tensor, traverser: int,
                        root: RootCtx, amask: torch.Tensor,
                        with_regrets: bool = False):
        """Bottom-up expected-value pass of ``strategy`` for the
        traverser.  At traverser nodes ``V = sum_a pi(a) Q(a)``; at
        opponent nodes the opponent's reach already weights the children,
        so ``V = sum_a Q(a)``.  Returns ``values [*b, N, H]`` and, if
        asked, the per-action regret increments ``[*b, N, H, A]`` (zero
        outside traverser rows)."""
        values = leaf_values.clone()
        q_minus_v = None
        if with_regrets:
            q_minus_v = values.new_zeros((*values.shape, self.A))
        for d, ls, le in self._levels_bottom_up():
            cvals = values[..., self._child_clamped[ls:le], :]  # [*b,n,A,H]
            m = amask[..., ls:le, :]  # [*b, n, A]
            cvals = torch.where(m[..., None], cvals, 0.0)
            strat = strategy[..., ls:le, :, :]  # [*b, n, H, A]
            v_trav = ordered_sum(strat * cvals.transpose(-1, -2), -1)
            v_opp = ordered_sum(cvals, -2)
            actor_is_trav = (self.node_player(d, root) == traverser)[
                ..., None, None]
            v = torch.where(actor_is_trav, v_trav, v_opp)
            keep = self._is_leaf[ls:le, None]
            values[..., ls:le, :] = torch.where(
                keep, values[..., ls:le, :], v)
            if with_regrets:
                q = cvals.transpose(-1, -2)  # [*b, n, H, A]
                inc = torch.where(m[..., None, :], q - v[..., None], 0.0)
                q_minus_v[..., ls:le, :, :] = torch.where(
                    actor_is_trav[..., None] & ~keep[..., None], inc, 0.0)
        return (values, q_minus_v) if with_regrets else values

    def backup_best_response(self, leaf_values: torch.Tensor,
                             traverser: int, root: RootCtx,
                             amask: torch.Tensor):
        """Bottom-up best-response pass: the traverser maximises per hand
        over children (the earliest action on ties), opponent nodes sum.
        Returns ``(values [*b, N, H], br [*b, N, H, A])``; ``br`` rows are
        one-hot at the traverser's interior nodes and zero elsewhere."""
        values = leaf_values.clone()
        br = values.new_zeros((*values.shape, self.A))
        neg = float("-inf")
        for d, ls, le in self._levels_bottom_up():
            cvals = values[..., self._child_clamped[ls:le], :]  # [*b,n,A,H]
            m = amask[..., ls:le, :]
            v_max, first = first_max(
                torch.where(m[..., None], cvals, neg), -2)
            v_sum = ordered_sum(torch.where(m[..., None], cvals, 0.0), -2)
            actor_is_trav = (self.node_player(d, root) == traverser)[
                ..., None, None]
            v = torch.where(actor_is_trav, v_max, v_sum)
            keep = self._is_leaf[ls:le, None]
            values[..., ls:le, :] = torch.where(
                keep, values[..., ls:le, :], v)
            row_ok = (actor_is_trav[..., None] & ~keep[..., None]
                      & m.any(-1)[..., None, None])
            br[..., ls:le, :, :] = torch.where(
                row_ok, first.transpose(-1, -2).to(self.dtype), 0.0)
        return values, br
