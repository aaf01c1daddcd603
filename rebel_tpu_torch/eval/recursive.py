"""Recursive subgame solving over the full game tree, the counterpart of
``rebel_tpu/eval/recursive.py``.

Every subgame of the recursion is a mask over one shared supertree, so
each *frontier* of the recursion is solved as one batch on the device
(lanes as the leading dimension); only the tree bookkeeping stays on the
host.  Two recursions:

* the sequential one, for any depth (:class:`BatchSubgameSolver`, the
  generic CFR/FP solver; :func:`compute_strategy_recursive`,
  :func:`compute_strategy_recursive_to_leaf`,
  :func:`compute_sampled_strategy_recursive_to_leaf`), one repeat at a
  time, as the in-training exploitability runs it;
* the batched one over many repeats at depth 2, the paper protocol
  (:class:`Grid2FrontierSolver`, the fused solve or a plain solver;
  :func:`compute_sampled_strategies_to_leaf_batch`).

Per-subgame random stop iterations (the emulation of training-time play)
are realised by running every iteration and taking each lane's policy at
its own ``t``: the same result as stopping at ``t``, with no ragged
shapes.  Stop iterations are drawn with ``np.random.RandomState``, as in
the JAX package, so both packages draw the same ones.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.core import (
    RootCtx,
    SolverContext,
    ValueFn,
    reach_eps,
)
from rebel_tpu_torch.solving.grid2 import Grid2Solver
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.solver import build_solver
from rebel_tpu_torch.tree import (
    NO_CHILD,
    TreeSpec,
    build_supertree,
    unroll_tree,
)

ENGINES = ("kernel", "plain", "fast")
# Lanes a frontier solve takes when ``Grid2FrontierSolver.chunk`` is None:
# the JAX package's 1024, but more for the fast engine, whose iterations
# are a Python loop of launches that larger solves amortise.
DEFAULT_CHUNK = {"kernel": 1024, "plain": 1024, "fast": 16384}


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


# ------------------------------------------------- sequential recursion
@dataclasses.dataclass(frozen=True, eq=False)
class BatchSubgameSolver:
    """The generic solver over a batch of subgames on one supertree, with
    each lane's average and sampling strategy taken at its own stop
    iteration.  Plain PyTorch on ``device``; the value net is evaluated by
    ``value_fn`` at the pseudo-leaves."""

    game: LiarsDice
    params: SubgameSolvingParams
    dtype: torch.dtype = torch.float64
    value_fn: ValueFn | None = None
    max_depth: int | None = None  # default: params.max_depth
    device: str | torch.device = "cuda"

    def __post_init__(self):
        depth = (self.params.max_depth if self.max_depth is None
                 else self.max_depth)
        tree = build_supertree(self.game, min(depth, self.game.max_depth))
        ctx = SolverContext(game=self.game, tree=tree, dtype=self.dtype,
                            device=self.device)
        object.__setattr__(self, "tree", tree)
        object.__setattr__(self, "ctx", ctx)
        object.__setattr__(self, "solver",
                           build_solver(ctx, self.params, self.value_fn))

    @torch.no_grad()
    def _solve_chunk(self, bids, players, beliefs, stops: np.ndarray):
        solver, ctx = self.solver, self.ctx
        dev = torch.device(self.device)
        root = RootCtx.of(self.game, torch.as_tensor(bids, device=dev),
                          torch.as_tensor(players, device=dev))
        beliefs = torch.as_tensor(beliefs, dtype=self.dtype, device=dev)
        state = solver.init(root, beliefs)
        snap_avg = solver.average_strategy(state, root)
        snap_samp = solver.sampling_strategy(state)
        stops_t = torch.as_tensor(stops, device=dev)
        num_iters = self.params.num_iters
        # Snapshots are taken before iteration t, and after the last one
        # for t == num_iters; only iterations some lane stops at need one.
        wanted = set(stops.tolist())
        for it in range(num_iters + 1):
            if it in wanted:
                take = (stops_t == it)[:, None, None, None]
                snap_avg = torch.where(
                    take, solver.average_strategy(state, root), snap_avg)
                snap_samp = torch.where(
                    take, solver.sampling_strategy(state), snap_samp)
            if it < num_iters:
                state = solver.step(state, it % 2, root)
        # Reaches under both candidate belief-propagation strategies: the
        # sampled mode walks with the sampling strategy, the unsampled
        # one with the average (they differ for CFR).
        reaches = [
            torch.stack([ctx.compute_reaches(s, beliefs[:, p], p, root)
                         for p in (0, 1)], dim=1)
            for s in (snap_samp, snap_avg)
        ]
        return tuple(x.cpu().numpy()
                     for x in (snap_avg, snap_samp, *reaches))

    def solve(self, bids, players, beliefs, stop_iters=None,
              chunk: int = 256):
        """``bids/players/stop_iters [B]`` (``None``: a full solve),
        ``beliefs [B, 2, H]`` -> numpy ``(average [B, N, H, A], sampling
        [B, N, H, A], reaches under sampling [B, 2, N, H], reaches under
        average [B, 2, N, H])``, solved ``chunk`` lanes at a time."""
        B = int(np.shape(bids)[0])
        if stop_iters is None:
            stop_iters = np.full((B,), self.params.num_iters)
        stop_iters = np.asarray(stop_iters, np.int64)
        outs = [
            self._solve_chunk(np.asarray(bids[lo:lo + chunk], np.int64),
                              np.asarray(players[lo:lo + chunk], np.int64),
                              np.asarray(beliefs)[lo:lo + chunk],
                              stop_iters[lo:lo + chunk])
            for lo in range(0, B, chunk)
        ]
        return tuple(np.concatenate([o[k] for o in outs], axis=0)
                     for k in range(4))


def _map_supertree_to_full(sup: TreeSpec, full: TreeSpec,
                           full_root: int) -> np.ndarray:
    """For a subgame rooted at full-tree node ``full_root``, the full-tree
    node of each supertree node (``NO_CHILD`` where the root's legal
    actions do not reach it), matched child by child on action ids."""
    m = np.full(sup.num_nodes, NO_CHILD, np.int64)
    m[0] = full_root
    for s in range(1, sup.num_nodes):
        p = m[sup.parent[s]]
        if p == NO_CHILD:
            continue
        m[s] = full.child_index[p, sup.last_bid[s]]
    return m


def _solve_frontier(bsolver: BatchSubgameSolver,
                    frontier: list[tuple[int, np.ndarray]], full: TreeSpec,
                    rng: np.random.RandomState | None,
                    iteration_weights: np.ndarray | None):
    """Solve a frontier of subgames in one batch; with
    ``iteration_weights``, each subgame stops at an iteration drawn from
    ``rng`` with those weights."""
    bids = np.array([full.last_bid[n] for n, _ in frontier], np.int32)
    players = np.array([full.node_player(n) for n, _ in frontier], np.int32)
    beliefs = np.stack([b for _, b in frontier])
    stops = None
    if iteration_weights is not None:
        p = iteration_weights / iteration_weights.sum()
        stops = rng.choice(len(iteration_weights), size=len(frontier),
                           p=p).astype(np.int32)
    return bids, players, bsolver.solve(bids, players, beliefs, stops)


def compute_strategy_recursive(game: LiarsDice,
                               params: SubgameSolvingParams,
                               value_fn: ValueFn | None = None,
                               dtype=torch.float64,
                               device="cuda") -> np.ndarray:
    """Root-policy-only recursion: every non-terminal full-tree node gets
    the root policy of a subgame solved at that node; its children
    recurse with Bayes-updated beliefs.  Returns ``[N_full, H, A]``."""
    full = unroll_tree(game)
    bsolver = BatchSubgameSolver(game, params, dtype, value_fn,
                                 device=device)
    eps = reach_eps(dtype)
    H, A = game.num_hands, game.num_actions
    strategy = np.zeros((full.num_nodes, H, A))
    frontier = [(0, np.full((2, H), 1.0 / H))]
    while frontier:
        frontier = [(n, b) for n, b in frontier if not full.is_terminal[n]]
        if not frontier:
            break
        _, _, (avg, _, _, _) = _solve_frontier(bsolver, frontier, full,
                                               None, None)
        next_frontier = []
        for i, (n, beliefs) in enumerate(frontier):
            root_policy = avg[i, 0]  # [H, A]
            strategy[n] = root_policy
            pid = full.node_player(n)
            for k in range(int(full.num_children[n])):
                a = int(full.first_action[n]) + k
                nb = beliefs.copy()
                nb[pid] = _normalize_safe_np(beliefs[pid] * root_policy[:, a],
                                             eps)
                next_frontier.append((int(full.children_begin[n]) + k, nb))
        frontier = next_frontier
    return strategy


def compute_strategy_recursive_to_leaf(
    game: LiarsDice,
    params: SubgameSolvingParams,
    value_fn: ValueFn | None = None,
    use_sampling_strategy: bool = False,
    sample_iters_seed: int | None = None,
    root_only: bool = False,
    dtype=torch.float64,
    device="cuda",
) -> np.ndarray:
    """Whole-subgame-copy recursion: each subgame's policy is copied into
    the full tree, and the recursion continues only at the subgame's
    non-terminal leaves, with the beliefs propagated along the path.

    With ``sample_iters_seed`` each subgame stops at a random even
    iteration with linear weights and its *sampling* strategy is copied
    (``use_sampling_strategy`` implied).  ``root_only``: only the root
    subgame is depth-limited; the ones below are solved to full depth.
    Returns ``[N_full, H, A]``."""
    full = unroll_tree(game)
    bsolver = BatchSubgameSolver(game, params, dtype, value_fn,
                                 device=device)
    deep_solver = (BatchSubgameSolver(game, params, dtype, value_fn,
                                      max_depth=game.max_depth,
                                      device=device)
                   if root_only else bsolver)
    eps = reach_eps(dtype)
    H, A = game.num_hands, game.num_actions
    strategy = np.zeros((full.num_nodes, H, A))
    rng = iteration_weights = None
    if sample_iters_seed is not None:
        rng = np.random.RandomState(sample_iters_seed)
        iteration_weights = stop_iteration_weights(params.num_iters)
        use_sampling_strategy = True

    frontier = [(0, np.full((2, H), 1.0 / H))]
    solver_i = bsolver
    while frontier:
        frontier = [(n, b) for n, b in frontier if not full.is_terminal[n]]
        if not frontier:
            break
        _, _, (avg, samp, r_samp, r_avg) = _solve_frontier(
            solver_i, frontier, full, rng, iteration_weights)
        copy_strat = samp if use_sampling_strategy else avg
        reaches = r_samp if use_sampling_strategy else r_avg  # [B,2,N,H]
        sup = solver_i.tree
        next_frontier = []
        for i, (n, _) in enumerate(frontier):
            m = _map_supertree_to_full(sup, full, n)
            valid = m != NO_CHILD
            strategy[m[valid]] = copy_strat[i][valid]
            for s in np.nonzero(valid & sup.is_leaf & ~sup.is_terminal)[0]:
                fn = int(m[s])
                if full.num_children[fn] == 0:
                    continue  # a leaf of the full tree: nothing below
                nb = np.stack([_normalize_safe_np(reaches[i, 0, s], eps),
                               _normalize_safe_np(reaches[i, 1, s], eps)])
                next_frontier.append((fn, nb))
        frontier = next_frontier
        solver_i = deep_solver
    return strategy


def compute_sampled_strategy_recursive_to_leaf(
    game: LiarsDice,
    params: SubgameSolvingParams,
    value_fn: ValueFn | None = None,
    seed: int = 0,
    root_only: bool = False,
    dtype=torch.float64,
    device="cuda",
) -> np.ndarray:
    """The training-time-emulating sampled strategy of one repeat."""
    return compute_strategy_recursive_to_leaf(
        game, params, value_fn, use_sampling_strategy=True,
        sample_iters_seed=seed, root_only=root_only, dtype=dtype,
        device=device)


# ------------------------------------------ batched depth-2 recursion


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
    - ``"fast"``: the batch-first solver in plain PyTorch
      (:class:`rebel_tpu_torch.solving.grid2.Grid2Solver`), any dtype, any
      ``value_fn``: the JAX package's default engine.
    - ``"kernel"``: the fused solve (:func:`rebel_tpu_torch.solving.
      grid2p.solve`), the engine the self-play generator runs: float32
      only, and the value net must be a ``CFVNet`` passed as ``net`` (the
      kernel computes the MLP in its loop); ``net=None`` gives zero leaf
      values, as ``zero_value_fn`` does.  On CUDA tensors it launches the
      CUDA kernel, on the CPU its plain version.  ``lane_block=None``
      takes :func:`~rebel_tpu_torch.solving.grid2p.choose_lane_block`'s
      for the game and net (kept in ``lane_block_used``, and its layout,
      :attr:`~rebel_tpu_torch.solving.grid2p.KernelPlan.layout`, in
      ``layout_used``; both None on the CPU).
    """

    game: LiarsDice
    params: SubgameSolvingParams
    dtype: torch.dtype = torch.float64
    value_fn: ValueFn | None = None
    chunk: int | None = None  # lanes a solve; None: DEFAULT_CHUNK's
    engine: str = "plain"
    net: torch.nn.Module | None = None
    lane_block: int | None = None
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
        lane_block, layout = self.lane_block, None
        if (self.engine == "kernel"
                and torch.device(self.device).type == "cuda"):
            if lane_block is None:
                # Every chunk is padded to a multiple of the block, so
                # only the fit decides it.
                lane_block = grid2p.choose_lane_block(
                    self.game, self.params, self.net, self._net_dtype(),
                    math.lcm(*grid2p.LANE_BLOCKS))
            layout = grid2p.kernel_plan(
                self.game, self.params, self.net, self._net_dtype(),
                lane_block, lane_block).layout
        object.__setattr__(self, "lane_block_used", lane_block)
        object.__setattr__(self, "layout_used", layout)

    def _net_dtype(self) -> torch.dtype:
        return getattr(torch, resolved_net_compute_dtype(
            "kernel", self.dtype, self.net_compute_dtype))

    def _solve_chunk(self, bids, players, beliefs, stops):
        dev = torch.device(self.device)
        args = (
            torch.as_tensor(bids, device=dev),
            torch.as_tensor(players, device=dev),
            torch.as_tensor(beliefs, dtype=self.dtype, device=dev),
            torch.as_tensor(stops, device=dev),
        )
        if self.engine == "kernel":
            return grid2p.solve(self.game, self.params, *args, self.net,
                                self._net_dtype(),
                                lane_block=self.lane_block_used)
        if self.engine == "fast":
            solver = Grid2Solver(self.game, self.params, self.dtype,
                                 self.value_fn, device=dev)
            root = RootCtx.of(self.game, args[0], args[1])
            state, snaps = solver.solve_with_snapshot(root, args[2],
                                                      args[3])
            return grid2p.Grid2Outputs(state.root_values_means, *snaps)
        mlp = None
        if self.value_fn is not None:
            mlp = lambda x: self.value_fn(x.T).T
        return grid2p.solve_loop(self.game, self.params, *args, mlp,
                                 self.dtype)

    def solve(self, bids, players, beliefs, stops):
        """``bids/players/stops [B]``, ``beliefs [B, 2, H]`` ->
        ``(snap0 [B, H, A], snap1 [B, A, H, A])`` as numpy.  The kernel
        needs a multiple of its lane block: a partial chunk is padded to
        one by repeating its first row, and the padding is cut off."""
        B = int(np.shape(bids)[0])
        LB = (self.lane_block_used or 1) if self.engine == "kernel" else 1
        chunk = self.chunk or DEFAULT_CHUNK[self.engine]
        outs0, outs1 = [], []
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
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



class ReferenceFrontierSolver(Grid2FrontierSolver):
    """The ``kernel`` engine with the kernel's plain PyTorch version
    (:func:`~rebel_tpu_torch.solving.grid2p.solve_reference`) in the
    kernel's place, on ``device``: what evaluations through the kernel are
    held to on the card.  On the CPU it is the kernel engine."""

    def _solve_chunk(self, bids, players, beliefs, stops):
        dev = torch.device(self.device)
        return grid2p.solve_reference(
            self.game, self.params, torch.as_tensor(bids, device=dev),
            torch.as_tensor(players, device=dev),
            torch.as_tensor(beliefs, dtype=torch.float32, device=dev),
            torch.as_tensor(stops, device=dev), self.net, self._net_dtype())

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
