"""Batched recursive subgame solving over the full game tree.

Counterpart of the batched part of ``rebel_tpu/eval/recursive.py``: all
subgames of the recursion share one depth-2 topology, so each *frontier*
of the recursion, over all repeats at once, is solved as lane batches on
the device; only the tree bookkeeping stays on the host.

Per-subgame random stop iterations (the emulation of training-time play)
are realised by running every iteration and taking each lane's sampling
policy at its own ``t``: the same result as stopping at ``t``, with no
ragged shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.core import ValueFn, reach_eps
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.tree import NO_CHILD, unroll_tree

ENGINES = ("kernel", "plain")


def _normalize_safe_np(x: np.ndarray, eps: float) -> np.ndarray:
    x = x + eps
    return x / x.sum(-1, keepdims=True)


def stop_iteration_weights(num_iters: int) -> np.ndarray:
    """Linear weights over even stop iterations, as training-time play
    stops."""
    return np.array(
        [0.0 if i % 2 else i / 2.0 + 1 for i in range(num_iters)]
    )


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def resolved_net_compute_dtype(engine: str, solver_dtype,
                               requested=None) -> str:
    """The dtype an evaluation engine computes the value net's MLP in,
    stamped into a result's provenance beside ``engine``: the kernel
    engine runs it in bfloat16 unless asked for float32, the plain engine
    in the solver's dtype."""
    if engine != "kernel":
        return _dtype_name(solver_dtype)
    return _dtype_name(torch.bfloat16 if requested is None else requested)


@dataclasses.dataclass(frozen=True, eq=False)
class Grid2FrontierSolver:
    """Depth-2 frontier solver over lanes; each lane is one (repeat,
    subgame root) pair, and its stop iteration ``t`` is realised by the
    snapshot-at-``t`` of the solve.

    ``engine`` picks the lane solver:

    - ``"plain"``: the batch-last solver in plain PyTorch
      (:class:`rebel_tpu_torch.solving.grid2b.Grid2BatchSolver` through
      :func:`~rebel_tpu_torch.solving.grid2p.solve_loop`), any dtype, any
      ``value_fn``.
    - ``"kernel"``: the fused solve (:func:`rebel_tpu_torch.solving.
      grid2p.solve`), the engine the self-play generator runs: float32
      only, and the value net must be a ``CFVNet`` passed as ``net`` (the
      kernel computes the MLP in its loop); ``net=None`` gives zero leaf
      values, as ``zero_value_fn`` does.  On CUDA tensors it launches the
      CUDA kernel, on the CPU its plain version.
    """

    game: LiarsDice
    params: SubgameSolvingParams
    dtype: torch.dtype = torch.float64
    value_fn: ValueFn | None = None
    chunk: int = 1024
    engine: str = "plain"
    net: torch.nn.Module | None = None
    lane_block: int = 8
    net_compute_dtype: torch.dtype | None = None  # None: see above
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.params.max_depth != 2:
            raise ValueError("Grid2FrontierSolver solves depth-2 subgames")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown frontier engine {self.engine!r}")
        if self.engine == "kernel":
            if self.dtype != torch.float32:
                raise ValueError(
                    "engine='kernel' solves in float32; got dtype="
                    f"{_dtype_name(self.dtype)} (use engine='plain' for "
                    "float64 runs)"
                )
            if (self.net is None and self.value_fn is not None
                    and getattr(self.value_fn, "__wrapped_kind__", None)
                    != "zero"):
                # The kernel computes the MLP in its loop from the net's
                # weights; a value_fn alone would be silently ignored,
                # turning a net evaluation into a zero-net one.
                raise ValueError(
                    "engine='kernel' evaluates the net from its weights; "
                    "a value_fn without net would silently run a zero-net "
                    "evaluation. Pass net (the checkpoint's CFVNet) or "
                    "drop value_fn for an explicit zero-net run."
                )

    def _solve_chunk(self, bids, players, beliefs, stops):
        dev = torch.device(self.device)
        args = (
            torch.as_tensor(bids, device=dev),
            torch.as_tensor(players, device=dev),
            torch.as_tensor(beliefs, dtype=self.dtype, device=dev),
            torch.as_tensor(stops, device=dev),
        )
        if self.engine == "kernel":
            net_dtype = getattr(torch, resolved_net_compute_dtype(
                "kernel", self.dtype, self.net_compute_dtype))
            return grid2p.solve(self.game, self.params, *args, self.net,
                                net_dtype, lane_block=self.lane_block)
        mlp = None
        if self.value_fn is not None:
            mlp = lambda x: self.value_fn(x.T).T
        return grid2p.solve_loop(self.game, self.params, *args, mlp,
                                 self.dtype)

    def solve(self, bids, players, beliefs, stops):
        """``bids/players/stops [B]``, ``beliefs [B, 2, H]`` ->
        ``(snap0 [B, H, A], snap1 [B, A, H, A])`` as numpy.  The kernel
        needs a multiple of ``lane_block`` lanes: a partial chunk is
        padded to one by repeating its first row, and the padding is cut
        off."""
        B = int(np.shape(bids)[0])
        LB = self.lane_block if self.engine == "kernel" else 1
        outs0, outs1 = [], []
        for lo in range(0, B, self.chunk):
            hi = min(lo + self.chunk, B)
            pad = -(hi - lo) % LB
            rows = lambda x, d: np.concatenate(
                [np.asarray(x[lo:hi], d)]
                + ([np.asarray(x[lo:lo + 1], d)] * pad if pad else []), 0)
            out = self._solve_chunk(
                rows(bids, np.int64), rows(players, np.int64),
                rows(np.asarray(beliefs), None), rows(stops, np.int64))
            outs0.append(out.snap0[:hi - lo].cpu().numpy())
            outs1.append(out.snap1[:hi - lo].cpu().numpy())
        return np.concatenate(outs0, 0), np.concatenate(outs1, 0)


def compute_sampled_strategies_to_leaf_batch(
    game: LiarsDice,
    params: SubgameSolvingParams,
    value_fn: ValueFn | None,
    seeds: list[int],
    dtype=torch.float64,
    chunk: int = 1024,
    fsolver: Grid2FrontierSolver | None = None,
    device="cuda",
) -> np.ndarray:
    """Sampled recursive-to-leaf strategies for many repeat seeds at
    ``max_depth == 2`` (the paper protocol).

    The recursion's frontier *structure* (which full-tree nodes get a
    subgame) is the same for every repeat; only beliefs and per-subgame
    stop iterations differ.  So all repeats advance in lockstep, and
    every frontier level is solved as one dense lane batch.

    Each repeat draws its stop iterations from ``RandomState(seed)`` in
    frontier order, draw for draw as a one-repeat-at-a-time recursion
    would.  Returns strategies ``[R, N_full, H, A]`` in the solver's
    dtype."""
    if params.max_depth != 2:
        raise ValueError("the batched recursion solves depth-2 subgames, "
                         f"not max_depth = {params.max_depth}")
    full = unroll_tree(game)
    if fsolver is None:
        fsolver = Grid2FrontierSolver(game, params, dtype, value_fn, chunk,
                                      device=device)
    eps = reach_eps(dtype)
    H, A = game.num_hands, game.num_actions
    liar = game.liar_call
    R = len(seeds)
    npdt = np.dtype(_dtype_name(dtype))
    strategy = np.zeros((R, full.num_nodes, H, A), npdt)
    rngs = [np.random.RandomState(s) for s in seeds]
    weights = stop_iteration_weights(params.num_iters)
    pw = weights / weights.sum()

    # frontier: list of (full-tree node, beliefs [R, 2, H])
    frontier = [(0, np.full((R, 2, H), 1.0 / H, npdt))]
    while frontier:
        frontier = [(n, b) for n, b in frontier if not full.is_terminal[n]]
        if not frontier:
            break
        F = len(frontier)
        nodes = [n for n, _ in frontier]
        bids = np.array([full.last_bid[n] for n in nodes], np.int32)
        players = np.array([full.node_player(n) for n in nodes], np.int32)
        stops = np.stack(
            [rng.choice(len(weights), size=F, p=pw) for rng in rngs]
        ).astype(np.int32)  # [R, F]
        beliefs = np.stack([b for _, b in frontier], axis=1)  # [R, F, 2, H]

        snap0, snap1 = fsolver.solve(
            np.tile(bids, R),
            np.tile(players, R),
            beliefs.reshape(R * F, 2, H),
            stops.reshape(R * F),
        )
        snap0 = snap0.reshape(R, F, H, A)
        snap1 = snap1.reshape(R, F, A, H, A)

        next_frontier = []
        for i, n in enumerate(nodes):
            strategy[:, n] = snap0[:, i]
            p0 = int(players[i])
            for a1 in range(int(bids[i]) + 1, A):
                c1 = full.child_index[n, a1]
                if c1 == NO_CHILD or a1 == liar:
                    continue
                strategy[:, c1] = snap1[:, i, a1]
                for a2 in range(a1 + 1, A):
                    c2 = full.child_index[c1, a2]
                    if c2 == NO_CHILD or a2 == liar:
                        continue
                    if full.num_children[c2] == 0:
                        continue
                    nb = np.empty((R, 2, H), npdt)
                    nb[:, p0] = _normalize_safe_np(
                        beliefs[:, i, p0] * snap0[:, i, :, a1], eps
                    )
                    nb[:, 1 - p0] = _normalize_safe_np(
                        beliefs[:, i, 1 - p0] * snap1[:, i, a1, :, a2], eps
                    )
                    next_frontier.append((int(c2), nb))
        frontier = next_frontier
    return strategy
