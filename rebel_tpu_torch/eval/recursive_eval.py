"""Evaluation harness: exploitability of a value net under recursive
solving.  Counterpart of ``rebel_tpu/eval/recursive_eval.py``.

* Phase 1 (:func:`full_solve`): solve the full tree for ``subgame_iters``
  iterations, with the exploitability at power-of-two iterations.
* Phase 2 (:func:`sampled_eval`): ``num_repeats`` independent sampled
  recursive-to-leaf strategies (seed = repeat id), averaged **weighted by
  the per-infoset reach** of the acting player (``final = sum(strat *
  reach) / (sum(reach) + 1e-6)``), with exploitability and EV against the
  full-tree strategy at power-of-two repeat counts.
* Machine-readable ``XXX {...}`` / ``YYY {...}`` JSON result lines.

At depth 2 (the paper protocol) the repeats run as lane batches through
the batched recursion; other depths take the sequential recursion, one
repeat at a time, on the plain engine.
"""

from __future__ import annotations

import json
import logging
import pathlib
from typing import Callable

import numpy as np
import torch

from rebel_tpu_torch.eval.recursive import (
    Grid2FrontierSolver,
    compute_sampled_strategies_to_leaf_batch,
    compute_sampled_strategy_recursive_to_leaf,
    resolved_net_compute_dtype,
)
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving.core import RootCtx, SolverContext, ValueFn
from rebel_tpu_torch.solving.exploitability import (
    compute_ev2,
    compute_exploitability2,
    full_tree_context,
    immediate_regret_summary,
    uniform_beliefs,
)
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.solver import build_solver

log = logging.getLogger(__name__)

ITERATE_BLOCK = 64  # iterates moved to the host, and valued, at a time


@torch.no_grad()
def full_solve(game: LiarsDice, params: SubgameSolvingParams,
               dtype=torch.float64, progress: bool = True,
               collect_iterates: bool = False, device="cuda"):
    """Phase 1: full-tree solve with the exploitability at power-of-two
    iterations.  With ``collect_iterates`` (CFR), the sampling strategy
    after every even iteration is returned for the immediate-regret
    report.  Returns ``(strategy [N, H, A] numpy, trajectory list,
    iterates)``; ``iterates`` is a list of host blocks ``[S_b, N*H*A]``."""
    ctx = full_tree_context(game, dtype, device)
    solver = build_solver(ctx, params.replace(max_depth=10**6))
    root = RootCtx.concrete(ctx.tree, device)
    state = solver.init(root, uniform_beliefs(game, dtype, device))
    collect = collect_iterates and params.use_cfr

    trajectory, iterates, pending = [], [], []
    checkpoints = sorted(
        {1 << k for k in range(params.num_iters.bit_length())}
        | {params.num_iters}
    )
    checkpoints = [c for c in checkpoints if c <= params.num_iters]

    def flush():
        if pending:
            iterates.append(torch.stack(pending).cpu().numpy())
            pending.clear()

    it = 0
    for target in checkpoints:
        while it < target:
            state = solver.step(state, it % 2, root)
            # Step, THEN collect at even iterations.
            if collect and it % 2 == 0:
                pending.append(solver.sampling_strategy(state).reshape(-1))
                if len(pending) == ITERATE_BLOCK:
                    flush()
            it += 1
        e0, e1 = compute_exploitability2(
            ctx, solver.average_strategy(state, root))
        trajectory.append(
            {"iter": it, "e0": e0, "e1": e1, "sum": (e0 + e1) / 2})
        if progress:
            log.info("Iter=%8d exploitabilities=(%.3e, %.3e) sum=%.3e",
                     it, e0, e1, (e0 + e1) / 2)
    flush()
    return (solver.average_strategy(state, root).cpu().numpy(), trajectory,
            iterates)


@torch.no_grad()
def acting_player_reach_batch(ctx: SolverContext,
                              strategies: np.ndarray) -> np.ndarray:
    """``[R, N, H, A] -> [R, N, H]``: the reach of each node's *acting
    player* from uniform beliefs under each repeat's strategy, the infoset
    weights of the sampled-strategy average."""
    root = RootCtx.concrete(ctx.tree, ctx.device)
    beliefs = uniform_beliefs(ctx.game, ctx.dtype, ctx.device)
    s = torch.as_tensor(strategies).to(device=ctx.device, dtype=ctx.dtype)
    r0 = ctx.compute_reaches(s, beliefs[0], 0, root)
    r1 = ctx.compute_reaches(s, beliefs[1], 1, root)
    player1 = (ctx._depth % 2).bool()  # the root player is 0
    return torch.where(player1[:, None], r1, r0).cpu().numpy()


def acting_player_reach(ctx: SolverContext,
                        strategy: np.ndarray) -> np.ndarray:
    """``[N, H]``: :func:`acting_player_reach_batch` of one strategy."""
    return acting_player_reach_batch(ctx, np.asarray(strategy)[None])[0]


def sampled_eval(
    game: LiarsDice,
    params: SubgameSolvingParams,
    value_fn: ValueFn | None,
    num_repeats: int,
    full_strategy: np.ndarray | None,
    mdp_depth: int = 2,
    dtype=torch.float64,
    progress: bool = True,
    max_chunk: int | None = None,
    on_report: Callable[[list], None] | None = None,
    acc_path: str | pathlib.Path | None = None,
    acc_sig: str = "",
    resume: bool = False,
    engine: str = "plain",
    net=None,
    net_compute_dtype=None,
    device="cuda",
    fsolver: Grid2FrontierSolver | None = None,
):
    """Phase 2: the reach-weighted average of sampled recursive
    strategies, repeats run as lane batches on the device at
    ``mdp_depth == 2`` and one at a time through the sequential recursion
    (plain engine only) at other depths.

    ``acc_path`` (if given) receives an atomic .npz snapshot of the
    reach-weighted accumulator after every power-of-two report and every
    device chunk; with ``resume=True`` a snapshot with the same
    ``acc_sig`` is loaded and the seed loop continues where it stopped.
    Per-seed results depend only on the seed index, so a resumed run is
    exact.

    ``on_report`` (if given) is called with the reports so far after
    every power-of-two report, so that a caller can stream partial
    results to disk.

    ``engine="kernel"`` solves the lanes with the fused kernel: pass the
    checkpoint's ``net``; see :class:`rebel_tpu_torch.eval.recursive.
    Grid2FrontierSolver`.  ``fsolver`` replaces the frontier solver that
    ``engine``, ``net`` and ``net_compute_dtype`` would build."""
    batched = mdp_depth == 2
    if engine != "plain" and not batched:
        raise NotImplementedError(
            f"engine={engine!r} solves depth-2 subgames (mdp_depth == 2), "
            f"not mdp_depth = {mdp_depth}; other depths take the plain "
            "engine, one repeat at a time")
    ctx = full_tree_context(game, dtype, device)
    sub_params = params.replace(max_depth=mdp_depth)
    if max_chunk is None:
        # Bound the [Rc, N, H, A] strategy block of a chunk to ~256 MB.
        per = ctx.tree.num_nodes * game.num_hands * game.num_actions * 8
        max_chunk = max(1, min(256, int(2 ** np.floor(np.log2(
            max(1, 256 * 2**20 // per))))))
    summed_strategy = None
    summed_reach = None
    reports = []
    done = 0
    if acc_path is not None:
        acc_path = pathlib.Path(acc_path)
    if resume and acc_path is not None and acc_path.exists():
        try:
            z = np.load(acc_path, allow_pickle=False)
            if str(z["sig"]) == acc_sig and int(z["done"]) <= num_repeats:
                summed_strategy = z["strategy"]
                summed_reach = z["reach"]
                done = int(z["done"])
                reports = json.loads(str(z["reports"]))
                log.info("resuming sampled eval at %d repeats", done)
            else:
                log.warning(
                    "accumulator %s does not match (sig %r vs %r); "
                    "starting fresh", acc_path, str(z["sig"]), acc_sig)
                # Move the refused snapshot aside now, so that a later
                # resume cannot pick up another net's accumulator.
                stale = acc_path.with_name(acc_path.name + ".stale")
                acc_path.replace(stale)
                log.warning("stale accumulator moved to %s", stale)
        except Exception as e:  # corrupt snapshot: start fresh
            log.warning("could not load accumulator %s (%s)", acc_path, e)

    def save_acc():
        if acc_path is None:
            return
        tmp = acc_path.with_name(acc_path.name + ".tmp.npz")
        with open(tmp, "wb") as f:
            np.savez(f, strategy=summed_strategy, reach=summed_reach,
                     done=done, reports=json.dumps(reports), sig=acc_sig)
        tmp.replace(acc_path)

    # One frontier solver across all seed blocks, of uniform full size:
    # the power-of-two report boundaries are met by the per-seed
    # accumulation below.
    if fsolver is None and batched:
        fsolver = Grid2FrontierSolver(
            game, sub_params, dtype, value_fn, engine=engine, net=net,
            net_compute_dtype=net_compute_dtype, device=device)
    # float32 accumulation, one seed at a time (cheap host adds), so that
    # every power-of-two repeat count gets a report whatever the device
    # chunking.  Other depths run the sequential recursion a repeat at a
    # time.
    step = max_chunk if batched else 1
    for lo in range(done, num_repeats, step):
        seeds = list(range(lo, min(lo + step, num_repeats)))
        if batched:
            strats = compute_sampled_strategies_to_leaf_batch(
                game, sub_params, value_fn, seeds, dtype=dtype,
                fsolver=fsolver)
        else:
            strats = np.stack([compute_sampled_strategy_recursive_to_leaf(
                game, sub_params, value_fn, seed=seed, dtype=dtype,
                device=device) for seed in seeds])
        strats = strats.astype(np.float32)
        reaches = acting_player_reach_batch(ctx, strats).astype(np.float32)
        chunk_saved = False
        for i in range(strats.shape[0]):
            contrib = strats[i] * reaches[i][:, :, None]
            rsum = reaches[i][:, :, None]
            if summed_strategy is None:
                summed_strategy, summed_reach = contrib, rsum.copy()
            else:
                summed_strategy += contrib
                summed_reach += rsum
            done += 1
            if (done & (done - 1)) != 0 and done != num_repeats:
                continue
            final = summed_strategy / (summed_reach + 1e-6)
            e0, e1 = compute_exploitability2(ctx, final)
            report = {"repeats": done, "e0": e0, "e1": e1,
                      "exploitability": (e0 + e1) / 2}
            if full_strategy is not None:
                ev0, ev1 = compute_ev2(ctx, full_strategy, final)
                report.update(ev_full_0=ev0, ev_full_1=ev1,
                              ev_full=(ev0 + ev1) / 2)
            reports.append(report)
            save_acc()
            chunk_saved = i == strats.shape[0] - 1
            if on_report is not None:
                on_report(reports)
            if progress:
                log.info(
                    "%5d: %.6g (%.6g,%.6g)\tEV of full: %s",
                    done, (e0 + e1) / 2, e0, e1,
                    "%.6g" % report["ev_full"]
                    if full_strategy is not None else "-",
                )
        # A kill between two reports should lose at most one chunk.
        if not chunk_saved:
            save_acc()
    final = summed_strategy / (summed_reach + 1e-6)
    return final, reports


def run_eval(
    game: LiarsDice,
    base_params: SubgameSolvingParams,
    value_fn: ValueFn | None = None,
    subgame_iters: int = 1024,
    num_repeats: int = 0,
    mdp_depth: int = 2,
    dtype=torch.float64,
    partial_path: str | pathlib.Path | None = None,
    regret_summary_report: bool = True,
    resume: bool = False,
    max_chunk: int | None = None,
    net_name: str | None = None,
    engine: str = "plain",
    net=None,
    net_compute_dtype=None,
    device="cuda",
) -> dict:
    """The whole evaluation; returns the dict behind the XXX/YYY lines.
    float64 is real arithmetic on CUDA and on the CPU.

    ``regret_summary_report=False`` skips collecting CFR iterates for the
    immediate-regret summary.

    ``partial_path`` (if given) receives an atomically rewritten JSON
    snapshot of the result after phase 1 and after every power-of-two
    sampled report, so a run that is killed keeps what it computed; the
    phase-2 accumulator is kept beside it (see :func:`sampled_eval`)."""
    params = base_params.replace(num_iters=subgame_iters)
    net_dtype = resolved_net_compute_dtype(engine, dtype, net_compute_dtype)

    def write_partial(obj: dict) -> None:
        if partial_path is None:
            return
        p = pathlib.Path(partial_path)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_text(json.dumps(obj, indent=1))
        tmp.replace(p)

    full_strategy, trajectory, iterates = full_solve(
        game, params, dtype,
        collect_iterates=params.use_cfr and regret_summary_report,
        device=device,
    )
    ctx = full_tree_context(game, dtype, device)
    e0, e1 = compute_exploitability2(ctx, full_strategy)

    results = {"full_tree": (e0 + e1) / 2}
    regret_summary = None
    if iterates:
        regs = immediate_regret_summary(ctx, iterates)
        regret_summary = {"max": float(regs.max()),
                          "mean": float(regs.mean())}
        log.info("immediate regrets: max %.3e mean %.3e",
                 regret_summary["max"], regret_summary["mean"])
    results_ev = {}
    reports = []
    fsolver = None
    if num_repeats > 0 and mdp_depth == 2:
        fsolver = Grid2FrontierSolver(
            game, params.replace(max_depth=2), dtype, value_fn,
            engine=engine, net=net, net_compute_dtype=net_compute_dtype,
            device=device)
    partial = {
        # Provenance: which net, engine and MLP dtype produced this.
        "game": f"{game.num_dice}x{game.num_faces}",
        "solver": "cfr" if params.use_cfr else "fp",
        "net": net_name,
        "engine": engine,
        "net_compute_dtype": net_dtype,
        # The kernel engine's lane block and layout on the card (else
        # None).
        "lane_block": fsolver and fsolver.lane_block_used,
        "layout": fsolver and fsolver.layout_used,
        "exploitability": dict(results),
        "ev": {},
        "full_trajectory": trajectory,
        "sampled_reports": reports,
        "immediate_regrets": regret_summary,
        "partial": True,
    }
    write_partial(partial)
    if num_repeats > 0:
        if value_fn is None:
            raise ValueError("num_repeats > 0 requires a value net")

        def stream(reps):
            partial["sampled_reports"] = reps
            partial["exploitability"]["repeated toleaf (partial)"] = reps[
                -1]["exploitability"]
            write_partial(partial)

        # The accumulator's strategies belong to ONE net, engine and MLP
        # dtype: resuming under another would blend two policies into one
        # cell, so the signature carries all three.
        acc_sig = (
            f"{game.num_dice}x{game.num_faces}-"
            f"{'cfr' if params.use_cfr else 'fp'}-{subgame_iters}-"
            f"{num_repeats}-net={net_name or 'anon'}-engine={engine}-"
            f"{net_dtype}"
        )
        final, reports = sampled_eval(
            game, params, value_fn, num_repeats, full_strategy, mdp_depth,
            dtype,
            on_report=stream if partial_path is not None else None,
            acc_path=(str(partial_path) + ".acc.npz"
                      if partial_path is not None else None),
            acc_sig=acc_sig,
            resume=resume,
            max_chunk=max_chunk,
            engine=engine,
            net=net,
            net_compute_dtype=net_compute_dtype,
            device=device,
            fsolver=fsolver,
        )
        last = reports[-1]
        results[f"repeated toleaf {num_repeats}"] = last["exploitability"]
        results_ev[f"repeated toleaf {num_repeats}"] = last["ev_full"]

    print("XXX " + json.dumps({k: str(v) for k, v in results.items()}))
    print("YYY " + json.dumps({k: str(v) for k, v in results_ev.items()}))
    return {
        "exploitability": results,
        "ev": results_ev,
        "full_trajectory": trajectory,
        "sampled_reports": reports,
        "immediate_regrets": regret_summary,
        "net_compute_dtype": net_dtype,
        "lane_block": partial["lane_block"],
        "layout": partial.get("layout"),
    }


def _load_net(net_path: str, game: LiarsDice, device="cuda"):
    """Load a checkpoint as ``(value_fn, net)`` from a ``.params`` export
    of the JAX trainer (a pickle of numpy arrays in the flax layout) or a
    ``Net2`` state dict saved with ``torch.save``.  Routed by content: a
    plain pickle of the flax layout loads directly, anything else goes
    through ``torch.load``.  ``net`` is what the kernel engine takes."""
    import pickle

    from rebel_tpu_torch.nets import convert
    from rebel_tpu_torch.nets.value_nets import net_value_fn

    try:
        net = convert.load_params_net(net_path, game, device)
    except (pickle.UnpicklingError, ValueError):
        # Not a plain pickle (torch.save writes a zip archive), or a
        # pickle of something else than the flax layout.
        net = convert.load_net2(net_path, game, device)
    return net_value_fn(net), net


def run_eval_from_config(cfg: dict, exp_dir: pathlib.Path,
                         device="cuda") -> dict:
    """The ``task: eval`` entry of ``python -m rebel_tpu_torch.run``:
    config keys ``env`` (game and subgame parameters) and ``eval``
    (``net``: ``zero``, ``oracle`` or a checkpoint path; ``subgame_iters``,
    ``num_repeats``, ``mdp_depth``, ``f64`` (default true), ``resume``,
    ``regret_summary``).  Solves with the plain engine, as the JAX
    package's default engine computes; partial results stream into
    ``exp_dir``."""
    env = cfg.get("env", {})
    game = LiarsDice(num_dice=env.get("num_dice", 1),
                     num_faces=env.get("num_faces", 4))
    sp = env.get("subgame_params", {})
    base_params = SubgameSolvingParams(
        num_iters=sp.get("num_iters", 1024),
        max_depth=sp.get("max_depth", 2),
        linear_update=sp.get("linear_update", True),
        use_cfr=sp.get("use_cfr", False),
    )
    ev = cfg.get("eval", {})
    net_path = ev.get("net", None)
    dtype = torch.float64 if ev.get("f64", True) else torch.float32
    value_fn = None
    if net_path == "zero":
        from rebel_tpu_torch.nets.value_nets import zero_value_fn

        value_fn = zero_value_fn(game)
    elif net_path == "oracle":
        from rebel_tpu_torch.nets.value_nets import make_oracle_value_fn

        value_fn = make_oracle_value_fn(game, base_params, dtype=dtype,
                                        device=device)
    elif net_path:
        value_fn = _load_net(net_path, game, device)[0]
    solver_tag = "cfr" if base_params.use_cfr else "fp"
    return run_eval(
        game, base_params, value_fn,
        subgame_iters=ev.get("subgame_iters", 1024),
        num_repeats=ev.get("num_repeats", 0),
        mdp_depth=ev.get("mdp_depth", base_params.max_depth),
        dtype=dtype,
        partial_path=pathlib.Path(exp_dir)
        / f"eval.{game.num_dice}x{game.num_faces}-{solver_tag}.partial",
        resume=bool(ev.get("resume", False)),
        regret_summary_report=bool(ev.get("regret_summary", True)),
        net_name=net_path if isinstance(net_path, str) else None,
        device=device,
    )
