"""Strategy statistics and net-quality diagnostics, the counterpart of
``rebel_tpu/eval/stats.py``: the per-node reaches and values of a
full-tree strategy (:func:`compute_strategy_stats`), and the mean squared
error of a value net against fresh full-depth best-response solves at
the most reachable nodes (:func:`eval_net`; the ``eval_mse/net_reach``
and ``eval_mse/fp_reach`` training metrics).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving.core import (
    RootCtx,
    SolverContext,
    ValueFn,
    normalize_safe,
    reach_eps,
)
from rebel_tpu_torch.solving.exploitability import (
    full_tree_context,
    uniform_beliefs,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.queries import get_query
from rebel_tpu_torch.solving.solver import build_solver
from rebel_tpu_torch.tree import build_supertree


@dataclasses.dataclass
class TreeStrategyStats:
    reach_probabilities: np.ndarray  # [2, N, H]
    values: np.ndarray  # [2, N, H]
    node_values: np.ndarray  # [2, N]
    node_reach: np.ndarray  # [N]


@torch.no_grad()
def compute_strategy_stats(ctx: SolverContext, strategy) -> TreeStrategyStats:
    """Reaches of both players from uniform beliefs, each player's
    expected values against the opponent's normalised reach, the node
    values under each player's own normalised reach, and the product of
    the two reach masses per node, for a full-tree ``strategy [N, H, A]``
    on the full-tree context ``ctx``."""
    t = ctx.tree
    root = RootCtx.concrete(t, ctx.device)
    amask = ctx.action_masks(root)
    beliefs = uniform_beliefs(ctx.game, ctx.dtype, ctx.device)
    eps = reach_eps(ctx.dtype)
    strategy = torch.as_tensor(strategy).to(device=ctx.device,
                                            dtype=ctx.dtype)
    reaches = torch.stack([ctx.compute_reaches(strategy, beliefs[p], p, root)
                           for p in (0, 1)])  # [2, N, H]
    node_reach = reaches[0].sum(-1) * reaches[1].sum(-1)

    values = []
    for player in (0, 1):
        op_beliefs = normalize_safe(reaches[1 - player], eps)
        v = torch.zeros((ctx.N, ctx.H), dtype=ctx.dtype, device=ctx.device)
        if ctx._tids.numel():
            v[ctx._tids] = ctx.terminal_values(op_beliefs, player, root)
        for d, ls, le in ctx._levels_bottom_up():
            cvals = v[ctx._child_clamped[ls:le]]  # [n, A, H]
            cvals = torch.where(amask[ls:le, :, None], cvals, 0.0)
            strat = strategy[ls:le]  # [n, H, A]
            v_own = torch.einsum("nha,nah->nh", strat, cvals)
            # Opponent nodes: each action weighted by the opponent's
            # probability of it under their normalised beliefs.
            action_prob = torch.einsum("nha,nh->na", strat, op_beliefs[ls:le])
            v_opp = torch.einsum("na,nah->nh", action_prob, cvals)
            vn = torch.where(ctx.node_player(d, root) == player, v_own,
                             v_opp)
            v[ls:le] = torch.where(ctx._is_leaf[ls:le, None], v[ls:le], vn)
        values.append(v)
    values = torch.stack(values)  # [2, N, H]
    own_beliefs = normalize_safe(reaches, 1e-6)
    node_values = torch.einsum("pnh,pnh->pn", own_beliefs, values)
    return TreeStrategyStats(
        reach_probabilities=reaches.cpu().numpy(),
        values=values.cpu().numpy(),
        node_values=node_values.cpu().numpy(),
        node_reach=node_reach.cpu().numpy(),
    )


@torch.no_grad()
def _br_values(game: LiarsDice, fp_iters: int, bids, players, beliefs,
               dtype, device) -> np.ndarray:
    """``[K, 2, H]`` root values of full-depth linear FP solves at
    ``fp_iters`` iterations, one per (bid, player, beliefs) lane, batched
    on the supertree in chunks of at most ~128 MB of solver state."""
    params = SubgameSolvingParams(num_iters=fp_iters, max_depth=10000,
                                  linear_update=True)
    tree = build_supertree(game, game.max_depth)
    ctx = SolverContext(game=game, tree=tree, dtype=dtype, device=device)
    solver = build_solver(ctx, params)
    per_lane = tree.num_nodes * game.num_hands * game.num_actions * 4
    chunk = int(max(8, min(128, 2 ** np.floor(np.log2(
        max(1, (128 << 20) // (4 * per_lane)))))))
    out = []
    for lo in range(0, len(bids), chunk):
        sl = slice(lo, lo + chunk)
        root = RootCtx.of(game, torch.as_tensor(bids[sl], device=device),
                          torch.as_tensor(players[sl], device=device))
        state = solver.init(root, torch.as_tensor(beliefs[sl]))
        state = solver.multistep(state, root)
        out.append(state.root_values_means.cpu().numpy())
    return np.concatenate(out, axis=0)


def eval_net(
    game: LiarsDice,
    net_strategy: np.ndarray,
    full_strategy: np.ndarray,
    mdp_depth: int,
    fp_iters: int,
    value_fn: ValueFn,
    traverse_by_net: bool,
    dtype=torch.float64,
    min_reach: float = 1e-6,
    device="cuda",
) -> float:
    """Mean squared error between the net's values and fresh full-depth
    best-response values, each weighted by the traverser's beliefs, over
    the non-terminal nodes at depths ``mdp_depth`` and ``2 * mdp_depth``
    whose reach (under the net's strategy with ``traverse_by_net``, else
    under the full solve's) is at least ``min_reach``."""
    ctx = full_tree_context(game, dtype, device)
    t = ctx.tree
    stats = compute_strategy_stats(
        ctx, net_strategy if traverse_by_net else full_strategy)
    sel = ((t.depth == mdp_depth) | (t.depth == 2 * mdp_depth)) \
        & ~t.is_terminal
    ids = np.nonzero(sel)[0]
    ids = ids[np.argsort(-stats.node_reach[ids], kind="stable")]
    ids = ids[stats.node_reach[ids] >= min_reach]
    if ids.size == 0:
        return 0.0
    # Per-node beliefs from the traversing policy's reaches.
    b = stats.reach_probabilities[:, ids]  # [2, K, H]
    beliefs = np.stack([b[0] / b[0].sum(-1, keepdims=True),
                        b[1] / b[1].sum(-1, keepdims=True)], axis=1)
    bids = t.last_bid[ids].astype(np.int64)
    players = (t.depth[ids] % 2).astype(np.int64)
    br_values = _br_values(game, fp_iters, bids, players, beliefs, dtype,
                           device)  # [K, 2, H]
    queries = np.stack([
        get_query(game, trav, int(t.last_bid[n]), int(t.depth[n] % 2),
                  beliefs[k][0], beliefs[k][1])
        for k, n in enumerate(ids) for trav in (0, 1)
    ])  # [2K, Q] float32
    net_values = value_fn(torch.as_tensor(queries, device=device))
    net_values = net_values.double().cpu().numpy().reshape(
        ids.size, 2, game.num_hands)
    mses = []
    for k in range(ids.size):
        for trav in (0, 1):
            w = beliefs[k][trav]
            nv = float((net_values[k, trav] * w).sum())
            bv = float((br_values[k, trav] * w).sum())
            mses.append((nv - bv) ** 2)
    return float(np.mean(mses))
