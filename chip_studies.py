#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port (``rebel_tpu_torch``) that are
not checks: what ``PERF.md`` quotes beside ``chip_smoke.py``'s readings.

    python3 chip_studies.py drift --out DIR
    python3 chip_studies.py f32-ladder --out DIR [--device cpu]
    python3 chip_studies.py sum-order --out DIR [--game 2x3] [--seed 62]
    python3 chip_studies.py eval-sum-order --out DIR [--game 2x3]

From the root of a checkout.  ``drift`` (card only): the exploitability
of a ``--repeats``-repeat sampled evaluation (depth-2 subgames, the
repo's trained nets) through each version of a pair, at each of the
pair's subgame iteration counts (:data:`PAIRS`: the fused kernel against
its plain version with bf16 operands at 2x3f, and the ``fast`` engine
against the kernel with an f32 MLP at 1x4f, each for CFR and FP), then
the ``fast`` engine's time an iteration by lanes; rows in
``DIR/drift.json``.  ``f32-ladder``: each net of :data:`LADDER` at the
paper protocol with the ``fast`` engine (``eval_all --engine fast``) and
with the kernel at an f32 MLP (``run_eval(engine="kernel",
net_compute_dtype=torch.float32)``); ``--num-repeats`` cuts the protocol,
``--nets`` picks rows by ``game-solver``, ``--engines`` the engines, and
``--device cpu`` runs on the CPU (the kernel engine then runs its plain
version); rows in ``DIR/f32_ladder.json``.  ``sum-order`` (the CPU by
default): the plain version of the fused solve with bf16 operands, the
repo's trained FP net of ``--game`` and ``chip_smoke.py``'s ``games``
inputs (``--lanes`` lanes from ``--seed``, ``--iters`` iterations), with
the MLP's sums taken in each order of :data:`ORDERS`, and with the f32
rounding of the kernel's epilogue (:func:`_kernel_epilogue_mlp`), each
held to the plain version's own; rows in ``DIR/sum_order.json``.
``eval-sum-order`` (the card by default): the plain version's
``--repeats``-repeat sampled evaluation over ``--iters`` subgame
iterations at ``--game`` with bf16 operands, with the MLP's sums in f32
and exact in f64, for each of ``--solvers``; rows in
``DIR/eval_sum_order.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

NETS = {
    ((1, 4), "cfr"): "results/liars_sp/r4_1x4cfr/ckpt/epoch990.params",
    ((1, 4), "fp"): "results/liars_sp/r5_1x4fp/ckpt/epoch800.params",
    ((1, 5), "cfr"): "results/liars_sp/r5_1x5cfr/ckpt/epoch990.params",
    ((2, 3), "cfr"): "results/liars_sp/r4_2x3cfr/ckpt/epoch990.params",
    ((2, 3), "fp"): "results/liars_sp/env.num_dice=2-env.num_faces=3-"
                    "exploit_every=100-max_epochs=1000-selfplay.batch=-"
                    "60727016/ckpt/epoch860.params",
}
# drift: name -> (game, solver, the version set beside the kernel,
# iterations)
PAIRS = {
    "kernel-plain-2x3-cfr": ((2, 3), "cfr", "plain", (64, 1024)),
    "kernel-plain-2x3-fp": ((2, 3), "fp", "plain", (64, 1024)),
    "kernel-fast-1x4-cfr": ((1, 4), "cfr", "fast", (16, 64, 256, 1024)),
    "kernel-fast-1x4-fp": ((1, 4), "fp", "fast", (16, 64, 256, 1024)),
}
TIMED_LANES = (1024, 16384)
# f32-ladder: the nets whose JAX-package `fast` evaluations are in
# results/eval_*_r*fast_1024rep.json.
LADDER = (((1, 4), "cfr"), ((1, 4), "fp"), ((1, 5), "cfr"))
ENGINES = ("fast", "kernel")
# sum-order: the FP nets by game.
FP_NETS = {(1, 5): "results/liars_sp/r4_1x5fp/ckpt/epoch990.params",
           (1, 6): "results/liars_sp/r4_1x6fp/ckpt/epoch990.params",
           (2, 3): NETS[(2, 3), "fp"]}


def _trunc32(x):
    """float64 to float32, rounded toward zero."""
    import torch

    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _f64(a, b):
    """Each sum exact in f64, rounded to f32 once."""
    return (a.double() @ b.double()).float()


def _tc_chained(a, b):
    """16-wide k steps exact, each added into one f32 accumulator and the
    result cut toward zero: the tensor cores' chained accumulation."""
    out = None
    for s in range(0, a.shape[1], 16):
        part = a[:, s:s + 16].double() @ b[s:s + 16].double()
        out = _trunc32(part if out is None else out.double() + part)
    return out


def _tc_steps(a, b):
    """16-wide k steps, each cut toward zero, added in f32 in order."""
    out = None
    for s in range(0, a.shape[1], 16):
        part = _trunc32(a[:, s:s + 16].double() @ b[s:s + 16].double())
        out = part if out is None else out + part
    return out


def _products(matmul):
    """A mode that sends every matrix product inside it through
    ``matmul``."""
    import torch

    class Products(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                return matmul(*args)
            return func(*args, **(kwargs or {}))

    return Products()


# name: the MLP's matmul (None: the plain version's own f32 product)
ORDERS = {"f32": None, "f64": _f64, "tc_chained": _tc_chained,
          "tc_steps": _tc_steps}


def _fma(a, b, c):
    """a * b + c rounded once to f32 (through f64, where the product is
    exact)."""
    return (a.double() * b.double() + c.double()).float()


# grid2_cfr.cu gelu_fast's coefficients, highest power first.
_GELU_POLY = (1.40787036032954e-05, -0.00034346830302456875,
              0.0037230956091636926, -0.024381732600758942,
              0.11078739955649257, -0.37547712975483916,
              1.1283452779263845)


def _kernel_epilogue_mlp(net):
    """The plain bf16 MLP (``grid2p.kernel_mlp``) with the f32 rounding of
    the kernel's epilogue (``mlp_tile``) in place of the plain version's:
    each row's LayerNorm sums taken as a quad of threads takes them (64
    columns each, in register order, the squares fused into the sum,
    then two shuffles), and the products that nvcc fuses with the add
    after them rounded once (the variance, the normalisation, scale and
    bias, the GELU polynomial's Horner steps)."""
    import torch

    def rnd(t):
        return t.to(torch.bfloat16).float()

    def gelu(x):
        z = torch.clamp(x * 0.7071067811865476, -2.4, 2.4)
        u = z * z
        poly = torch.full_like(u, _GELU_POLY[0])
        for c in _GELU_POLY[1:]:
            poly = _fma(u, poly, torch.full_like(u, c))
        half = torch.full_like(u, 0.5)
        return x * _fma(half, z * poly, half)

    def mlp(x):
        x = x.float().T
        for lin, ln in net.hidden_layers():
            x = rnd(x) @ rnd(lin.weight.float()).T + lin.bias.float()
            if ln is not None:
                n = x.shape[0]
                # thread j of a quad holds columns 8 m + 2 j + e
                cols = x.view(n, 32, 4, 2)
                s = x.new_zeros(n, 4)
                q = x.new_zeros(n, 4)
                for m in range(32):
                    for e in range(2):
                        v = cols[:, m, :, e]
                        s = s + v
                        q = _fma(v, v, q)
                mu = (((s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3]))
                      / x.shape[1])[:, None]
                ex2 = (((q[:, 0] + q[:, 1]) + (q[:, 2] + q[:, 3]))
                       / x.shape[1])[:, None]
                r = torch.rsqrt(torch.clamp(_fma(-mu, mu, ex2), min=0.0)
                                + 1e-5)
                x = _fma(x, r, -(mu * r))
                x = _fma(x, ln.weight.float(), ln.bias.float())
            x = gelu(x)
        out = net.output
        x = rnd(x) @ rnd(out.weight.float()).T + out.bias.float()
        return x.T

    return mlp


def drift(args) -> list[dict]:
    import torch

    from rebel_tpu_torch.eval import recursive, recursive_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.solving.core import RootCtx
    from rebel_tpu_torch.solving.grid2 import Grid2Solver
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    if not torch.cuda.is_available():
        raise SystemExit("chip_studies.py drift measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []

    def emit(row: dict) -> None:
        rows.append(row)
        print(json.dumps(row), flush=True)
        (args.out / "drift.json").write_text(json.dumps(rows, indent=1))

    for name in args.pairs:
        (nd, nf), solver, other, iter_counts = PAIRS[name]
        game = LiarsDice(nd, nf)
        value_fn, net = recursive_eval._load_net(
            str(ROOT / NETS[(nd, nf), solver]), game, dev)
        dtype = torch.bfloat16 if other == "plain" else torch.float32
        for iters in iter_counts:
            sub = SubgameSolvingParams(num_iters=iters, max_depth=2,
                                       linear_update=True,
                                       use_cfr=solver == "cfr")
            kernel = recursive.Grid2FrontierSolver(
                game, sub, torch.float32, None, engine="kernel", net=net,
                net_compute_dtype=dtype, device=dev)
            if other == "plain":
                beside = recursive.ReferenceFrontierSolver(
                    game, sub, torch.float32, None, chunk=16384,
                    engine="kernel", net=net, net_compute_dtype=dtype,
                    device=dev)
            else:
                beside = recursive.Grid2FrontierSolver(
                    game, sub, torch.float32, value_fn, engine="fast",
                    device=dev)
            got, secs = {}, {}
            for label, fsolver in (("kernel", kernel), (other, beside)):
                t0 = time.perf_counter()
                _, reports = recursive_eval.sampled_eval(
                    game, sub, value_fn, args.repeats, None,
                    dtype=torch.float32, progress=False, device=dev,
                    fsolver=fsolver)
                got[label] = reports[-1]["exploitability"]
                secs[label] = time.perf_counter() - t0
            emit(dict(pair=name, iters=iters, repeats=args.repeats,
                      net_compute_dtype=str(dtype).split(".")[-1],
                      lane_block=kernel.lane_block_used, **{
                          f"{k}_exploitability": v for k, v in got.items()},
                      **{f"{k}_s": v for k, v in secs.items()},
                      relative_diff=abs(got[other] - got["kernel"])
                      / got["kernel"]))

    # The fast engine's solve, an iteration, by lanes.
    game = LiarsDice(1, 4)
    value_fn = recursive_eval._load_net(str(ROOT / NETS[(1, 4), "cfr"]),
                                        game, dev)[0]
    iters = 32
    sub = SubgameSolvingParams(num_iters=iters, max_depth=2,
                               linear_update=True, use_cfr=True)
    solver = Grid2Solver(game, sub, torch.float32, value_fn, device=dev)
    gen = torch.Generator().manual_seed(0)
    for lanes in TIMED_LANES:
        bids = torch.randint(-1, game.num_actions - 1, (lanes,),
                             generator=gen).to(dev)
        players = torch.randint(0, 2, (lanes,), generator=gen).to(dev)
        expo = -torch.log(torch.rand((lanes, 2, game.num_hands),
                                     generator=gen))
        beliefs = (expo / expo.sum(-1, keepdim=True)).to(dev)
        t_stop = torch.randint(0, iters + 1, (lanes,), generator=gen).to(dev)
        root = RootCtx.of(game, bids, players)
        for timed in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve_with_snapshot(root, beliefs, t_stop)
            torch.cuda.synchronize()
            if timed:
                ms = (time.perf_counter() - t0) / iters * 1e3
                emit(dict(fast_engine_lanes=lanes, ms_per_iteration=ms,
                          ms_per_lane_solve_of_1024_iterations=(
                              ms * 1024 / lanes)))
    return rows


def f32_ladder(args) -> list[dict]:
    import torch

    from rebel_tpu_torch.eval import eval_all
    from rebel_tpu_torch.eval.recursive_eval import _load_net, run_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    rows = []
    for (nd, nf), solver in LADDER:
        gstr = f"{nd}x{nf}"
        if f"{gstr}-{solver}" not in args.nets:
            continue
        ckpt = str(ROOT / NETS[(nd, nf), solver])
        for engine in args.engines:
            t0 = time.perf_counter()
            launches0 = grid2p.solve.launches
            if engine == "fast":
                (row,) = eval_all.main([
                    "--games", gstr, "--solvers", solver, "--net", ckpt,
                    "--engine", "fast", "--device", args.device,
                    "--num-repeats", str(args.num_repeats),
                    "--out", str(args.out / f"eval_{gstr}_{solver}_fast.json")])
                rebel, dtype, lane_block = (row["rebel"],
                                            row["net_compute_dtype"],
                                            row["lane_block"])
            else:
                game = LiarsDice(nd, nf)
                value_fn, net = _load_net(ckpt, game, args.device)
                res = run_eval(
                    game, SubgameSolvingParams(
                        max_depth=2, linear_update=True,
                        use_cfr=solver == "cfr"),
                    value_fn,
                    num_repeats=args.num_repeats, dtype=torch.float32,
                    net_name=ckpt, engine="kernel", net=net,
                    net_compute_dtype=torch.float32, device=args.device)
                rebel = res["exploitability"][
                    f"repeated toleaf {args.num_repeats}"]
                dtype, lane_block = res["net_compute_dtype"], res["lane_block"]
            rows.append(dict(
                game=gstr, solver=solver, net=NETS[(nd, nf), solver],
                engine=engine, device=args.device, net_compute_dtype=dtype,
                lane_block=lane_block, num_repeats=args.num_repeats,
                rebel=rebel, wall_s=time.perf_counter() - t0,
                launches=grid2p.solve.launches - launches0))
            print(json.dumps(rows[-1]), flush=True)
            (args.out / "f32_ladder.json").write_text(
                json.dumps(rows, indent=1))
    return rows


def sum_order(args) -> list[dict]:
    import torch

    from rebel_tpu_torch.eval.recursive_eval import _load_net
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    nd, nf = (int(x) for x in args.game.split("x"))
    game = LiarsDice(nd, nf)
    net = _load_net(str(ROOT / FP_NETS[nd, nf]), game, args.device)[1]
    # chip_smoke.py's random_inputs
    g = torch.Generator().manual_seed(args.seed)
    B = args.lanes
    bids = torch.randint(-1, game.num_actions - 1, (B,), generator=g)
    players = torch.randint(0, 2, (B,), generator=g)
    expo = -torch.log(torch.rand((B, 2, game.num_hands), generator=g))
    beliefs = expo / expo.sum(-1, keepdim=True)
    t_stop = torch.randint(0, args.iters + 1, (B,), generator=g)
    inputs = [x.to(args.device) for x in (bids, players, beliefs, t_stop)]
    params = SubgameSolvingParams(num_iters=args.iters, max_depth=2,
                                  use_cfr=False, linear_update=True)
    plain = grid2p.kernel_mlp(net, torch.bfloat16)
    outs = {}
    for name, matmul in ORDERS.items():
        def mlp(x, matmul=matmul):
            if matmul is None:
                return plain(x)
            with _products(matmul):
                return plain(x)
        outs[name] = grid2p.solve_loop(game, params, *inputs, mlp)
    outs["kernel_epilogue"] = grid2p.solve_loop(
        game, params, *inputs, _kernel_epilogue_mlp(net))
    rows = []
    for a, b in [("f32", o) for o in outs if o != "f32"] + [
            ("tc_chained", "tc_steps")]:
        rvm = (outs[a].rvm - outs[b].rvm).abs().flatten(1).amax(1)
        rows.append(dict(game=args.game, solver="fp", iters=args.iters,
                         lanes=B, seed=args.seed, pair=f"{a}-{b}",
                         rvm_mean=float((outs[a].rvm - outs[b].rvm).abs()
                                        .mean()),
                         rvm_max=float(rvm.max()),
                         worst_lane=int(rvm.argmax()),
                         lanes_rvm_over_1e3=int((rvm > 1e-3).sum())))
        print(json.dumps(rows[-1]), flush=True)
    (args.out / "sum_order.json").write_text(json.dumps(rows, indent=1))
    return rows


def eval_sum_order(args) -> list[dict]:
    import torch

    from rebel_tpu_torch.eval import recursive, recursive_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    nd, nf = (int(x) for x in args.game.split("x"))
    game = LiarsDice(nd, nf)
    plain_mlp = grid2p.kernel_mlp
    rows = []
    for solver in args.solvers:
        value_fn, net = recursive_eval._load_net(
            str(ROOT / NETS[(nd, nf), solver]), game, args.device)
        sub = SubgameSolvingParams(num_iters=args.iters, max_depth=2,
                                   linear_update=True,
                                   use_cfr=solver == "cfr")
        got = {}
        for name in ("f32", "f64"):
            def mlp(net_, dtype=torch.float32, gelu="auto", ablate="",
                    matmul=ORDERS[name]):
                f = plain_mlp(net_, dtype, gelu, ablate)
                if matmul is None:
                    return f

                def g(x):
                    with _products(matmul):
                        return f(x)
                return g
            grid2p.kernel_mlp = mlp
            try:
                fsolver = recursive.ReferenceFrontierSolver(
                    game, sub, torch.float32, None, chunk=16384,
                    engine="kernel", net=net,
                    net_compute_dtype=torch.bfloat16, device=args.device)
                t0 = time.perf_counter()
                _, reports = recursive_eval.sampled_eval(
                    game, sub, value_fn, args.repeats, None,
                    dtype=torch.float32, progress=False, device=args.device,
                    fsolver=fsolver)
            finally:
                grid2p.kernel_mlp = plain_mlp
            got[name] = (reports[-1]["exploitability"],
                         time.perf_counter() - t0)
        rows.append(dict(game=args.game, solver=solver, iters=args.iters,
                         repeats=args.repeats, device=args.device,
                         f32_exploitability=got["f32"][0],
                         f64_exploitability=got["f64"][0],
                         f32_s=got["f32"][1], f64_s=got["f64"][1],
                         relative_diff=abs(got["f64"][0] - got["f32"][0])
                         / got["f32"][0]))
        print(json.dumps(rows[-1]), flush=True)
        (args.out / "eval_sum_order.json").write_text(
            json.dumps(rows, indent=1))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="study", required=True)
    d = sub.add_parser("drift")
    d.add_argument("--out", type=pathlib.Path, required=True)
    d.add_argument("--pairs", nargs="+", default=list(PAIRS),
                   choices=list(PAIRS))
    d.add_argument("--repeats", type=int, default=16)
    f = sub.add_parser("f32-ladder")
    f.add_argument("--out", type=pathlib.Path, required=True)
    f.add_argument("--nets", nargs="+",
                   default=[f"{nd}x{nf}-{s}" for (nd, nf), s in LADDER])
    f.add_argument("--engines", nargs="+", default=list(ENGINES),
                   choices=ENGINES)
    f.add_argument("--num-repeats", type=int, default=1024)
    f.add_argument("--device", default="cuda")
    o = sub.add_parser("sum-order")
    o.add_argument("--out", type=pathlib.Path, required=True)
    o.add_argument("--game", default="2x3",
                   choices=[f"{nd}x{nf}" for nd, nf in FP_NETS])
    o.add_argument("--seed", type=int, default=62)
    o.add_argument("--lanes", type=int, default=256)
    o.add_argument("--iters", type=int, default=64)
    o.add_argument("--device", default="cpu")
    e = sub.add_parser("eval-sum-order")
    e.add_argument("--out", type=pathlib.Path, required=True)
    e.add_argument("--game", default="2x3", choices=["1x4", "2x3"])
    e.add_argument("--solvers", nargs="+", default=["fp", "cfr"],
                   choices=["fp", "cfr"])
    e.add_argument("--repeats", type=int, default=4)
    e.add_argument("--iters", type=int, default=1024)
    e.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    args.out.mkdir(parents=True, exist_ok=True)
    study = {"drift": drift, "f32-ladder": f32_ladder,
             "sum-order": sum_order,
             "eval-sum-order": eval_sum_order}[args.study]
    return study(args)


if __name__ == "__main__":
    main()
