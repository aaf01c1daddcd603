"""Value-net function backends.

A solver consumes a plain function ``queries [..., L, Q] -> values
[..., L, H]``.  Counterpart of ``rebel_tpu/nets/value_nets.py``:

* :func:`zero_value_fn`: constant zeros; exercises the plumbing without a
  model.
* :func:`make_oracle_value_fn`: answers each query by solving the full
  game from the queried state, all queries of a batch in lockstep on one
  masked supertree.
* :func:`net_value_fn`: a trained :class:`~rebel_tpu_torch.nets.cfv_net.
  CFVNet` as such a function.
"""

from __future__ import annotations

import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving.core import RootCtx, SolverContext
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.tree import build_supertree


def zero_value_fn(game: LiarsDice):
    def value_fn(queries: torch.Tensor) -> torch.Tensor:
        return queries.new_zeros((*queries.shape[:-1], game.num_hands))

    # Read by the kernel engine of Grid2FrontierSolver: a zero value_fn
    # without a net is a legitimate zero-net evaluation; any other
    # value_fn without a net would be silently ignored there.
    value_fn.__wrapped_kind__ = "zero"
    return value_fn


def net_value_fn(net: torch.nn.Module):
    """``net`` as a value function in the dtype of its queries."""

    @torch.no_grad()
    def value_fn(queries: torch.Tensor) -> torch.Tensor:
        dt = next(net.parameters()).dtype
        return net(queries.to(dt)).to(queries.dtype)

    return value_fn


def decode_query_arrays(game: LiarsDice, queries: torch.Tensor):
    """``queries [..., Q]`` -> ``(traverser, last_bid, player [...],
    beliefs [..., 2, H])``."""
    A, H = game.num_actions, game.num_hands
    player = queries[..., 0].long()
    traverser = queries[..., 1].long()
    onehot = queries[..., 2:2 + A]
    last_bid = torch.where(onehot.amax(-1) > 0.5, onehot.argmax(-1), -1)
    beliefs = torch.stack(
        [queries[..., 2 + A:2 + A + H], queries[..., 2 + A + H:]], dim=-2)
    return traverser, last_bid, player, beliefs


def make_oracle_value_fn(game: LiarsDice, params: SubgameSolvingParams,
                         dtype=torch.float32, device="cuda"):
    """Ground-truth oracle: a full-depth solve per query on a masked
    supertree (one static topology covers every queried root state)."""
    from rebel_tpu_torch.solving.solver import build_solver

    ctx = SolverContext(game=game, tree=build_supertree(game, None),
                        dtype=dtype, device=device)
    solver = build_solver(ctx, params, value_fn=None)

    @torch.no_grad()
    def value_fn(queries: torch.Tensor) -> torch.Tensor:
        q = queries.to(device=ctx.device)
        traverser, last_bid, player, beliefs = decode_query_arrays(game, q)
        root = RootCtx.of(game, last_bid, player)
        state = solver.multistep(solver.init(root, beliefs), root)
        idx = traverser[..., None, None].expand(*traverser.shape, 1,
                                                game.num_hands)
        out = torch.gather(state.root_values_means, -2, idx).squeeze(-2)
        return out.to(device=queries.device, dtype=queries.dtype)

    return value_fn
