"""Evaluation sweep over games and solvers:

    python -m rebel_tpu_torch.eval.eval_all --games 1x4 --solvers cfr fp \\
        --net results/liars_sp/r4_1x4cfr/ckpt/epoch990.params

runs, per (game, solver), the full-tree solve and the sampled recursive
evaluation (``--mdp-depth 2 --subgame-iters 1024 --num-repeats 1024`` by
default, the paper protocol) and writes the rows to ``--out``.  It runs on
the card (``--device cuda``, the fused kernel with a bfloat16 MLP) unless
``--device cpu`` is given; ``--f64`` solves in float64 with the plain
engine; ``--engine fast`` solves with the batch-first plain solver, the
JAX package's default, with the MLP in the solver's dtype.  ``--net`` is
``zero``, ``oracle`` or a checkpoint (a ``.params`` export or a ``Net2``
state dict); without it, ``--ckpt-root`` takes the latest
``epoch*.params`` under a directory.  Counterpart of the arguments of
``scripts/eval_all.py`` that drive ``run_eval``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time


def parse_game(s: str) -> tuple[int, int]:
    nd, nf = s.split("x")
    return int(nd), int(nf)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--games", nargs="+", default=["1x4", "1x5", "1x6", "2x3"])
    ap.add_argument("--solvers", nargs="+", default=["fp", "cfr"])
    ap.add_argument("--net", default=None,
                    help="'oracle', 'zero', or a checkpoint path")
    ap.add_argument("--ckpt-root", default=None,
                    help="without --net: the latest epoch*.params under "
                    "this directory")
    ap.add_argument("--subgame-iters", type=int, default=1024)
    ap.add_argument("--num-repeats", type=int, default=1024)
    ap.add_argument("--mdp-depth", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--f64", action="store_true",
                    help="solve in float64 (plain engine only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed phase-2 evaluation from its "
                    "accumulator snapshot "
                    "(<out>.<game>-<solver>.partial.acc.npz); exact, since "
                    "per-seed strategies depend only on the seed index")
    ap.add_argument("--no-regrets", action="store_true",
                    help="skip the CFR immediate-regret summary")
    ap.add_argument("--max-chunk", type=int, default=None,
                    help="repeats per device batch in the sampled "
                    "evaluation (default: bounded by a ~256 MB strategy "
                    "block)")
    ap.add_argument("--engine", default=None,
                    choices=("kernel", "plain", "fast"),
                    help="phase-2 lane solver: 'kernel' = the fused solve "
                    "the self-play generator runs (float32, checkpoint or "
                    "zero nets only; the default without --f64); 'plain' = "
                    "the batch-last solver in plain PyTorch (any dtype, any "
                    "net; the default with --f64); 'fast' = the batch-first "
                    "solver in plain PyTorch (any dtype, any net)")
    ap.add_argument("--out", default="eval_all_results.json")
    args = ap.parse_args(argv)

    import torch

    from rebel_tpu_torch.eval.recursive_eval import _load_net, run_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.nets.value_nets import (
        make_oracle_value_fn,
        zero_value_fn,
    )
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not "
                         "available (pass --device cpu)")
    engine = args.engine or ("plain" if args.f64 else "kernel")
    if engine == "kernel" and args.f64:
        raise SystemExit("--engine kernel solves in float32; use --engine "
                         "plain with --f64")
    if engine == "kernel" and args.net == "oracle":
        raise SystemExit("--engine kernel computes leaf values in the "
                         "kernel and cannot wrap the oracle value "
                         "function; use --engine plain")
    dtype = torch.float64 if args.f64 else torch.float32
    rows = []
    for gstr in args.games:
        nd, nf = parse_game(gstr)
        game = LiarsDice(num_dice=nd, num_faces=nf)
        for solver in args.solvers:
            params = SubgameSolvingParams(
                num_iters=args.subgame_iters, max_depth=args.mdp_depth,
                linear_update=True, use_cfr=solver == "cfr",
            )
            value_fn = net = None
            net_name = args.net or "none"
            if args.net == "oracle":
                value_fn = make_oracle_value_fn(
                    game, params.replace(max_depth=10**6), dtype=dtype,
                    device=args.device)
            elif args.net == "zero":
                value_fn = zero_value_fn(game)
            elif args.net:
                value_fn, net = _load_net(args.net, game, args.device)
            elif args.ckpt_root:
                ckpts = sorted(
                    pathlib.Path(args.ckpt_root).rglob("epoch*.params"),
                    key=lambda p: int(p.stem[5:]))
                if not ckpts:
                    print(f"no checkpoints under {args.ckpt_root}; "
                          "skipping")
                    continue
                net_name = str(ckpts[-1])
                value_fn, net = _load_net(net_name, game, args.device)

            # Progress streams to a per-row partial file, so a run that
            # is killed keeps every report it computed; finished rows
            # land in <out> at once.
            partial = pathlib.Path(f"{args.out}.{gstr}-{solver}.partial")
            launches0 = grid2p.solve.launches
            t0 = time.perf_counter()
            result = run_eval(
                game, params, value_fn,
                subgame_iters=args.subgame_iters,
                num_repeats=args.num_repeats if value_fn is not None else 0,
                mdp_depth=args.mdp_depth,
                dtype=dtype,
                partial_path=partial,
                regret_summary_report=not args.no_regrets,
                resume=args.resume,
                max_chunk=args.max_chunk,
                net_name=net_name,
                engine=engine,
                net=net,
                device=args.device,
            )
            rows.append({
                "game": gstr,
                "solver": solver,
                "net": net_name,
                "engine": engine,
                "device": args.device,
                "net_compute_dtype": result.get("net_compute_dtype"),
                "lane_block": result.get("lane_block"),
                # Host seconds of the row and the fused kernel's launches.
                "wall_s": time.perf_counter() - t0,
                "launches": grid2p.solve.launches - launches0,
                "full_tree": result["exploitability"].get("full_tree"),
                "rebel": next(
                    (v for k, v in result["exploitability"].items()
                     if k.startswith("repeated")), None),
                "sampled_reports": result.get("sampled_reports"),
                "full_trajectory": result.get("full_trajectory"),
                "immediate_regrets": result.get("immediate_regrets"),
            })
            pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
            for p in (partial, pathlib.Path(str(partial) + ".acc.npz")):
                if p.exists():
                    p.unlink()

    print(f"\n{'game':>6} {'solver':>6} {'full_tree':>12} {'rebel':>12}")
    for r in rows:
        reb = f"{r['rebel']:.6f}" if r["rebel"] is not None else "-"
        print(f"{r['game']:>6} {r['solver']:>6} {r['full_tree']:>12.6f} "
              f"{reb:>12}")
    print(f"\nwritten: {args.out}")
    return rows


if __name__ == "__main__":
    main()
