#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port (``rebel_tpu_torch``) that are
not checks: what ``PERF.md`` quotes beside ``chip_smoke.py``'s readings.

    python3 chip_studies.py drift --out DIR
    python3 chip_studies.py f32-ladder --out DIR [--device cpu]
    python3 chip_studies.py sum-order --out DIR [--game 2x3] [--seed 62]
        [--fresh WIDTHxLAYERS --net-seed N --solver cfr]
    python3 chip_studies.py eval-sum-order --out DIR [--game 2x3]
    python3 chip_studies.py same-bits --old PATH --out DIR [--large
        [--cells CELL ...]]
    python3 chip_studies.py launches --out DIR
    python3 chip_studies.py plain-ms --out DIR
    python3 chip_studies.py bounds --out DIR [--games 2x5 ...]

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
repo's trained FP net of ``--game`` (or, with ``--fresh WIDTHxLAYERS``,
the fresh net of ``chip_smoke.py``'s ``widths`` phase from
``--net-seed``, ``--solver`` CFR or FP, ``--noln`` without LayerNorm;
``--operands f32``: f32 operands, the orders ``f32``, ``f64`` and
``f64_solve``, the whole solve in f64)
and ``chip_smoke.py``'s ``games`` inputs (``--lanes`` lanes from
``--seed``, ``--iters`` iterations), with the MLP's sums taken in each
order of :data:`ORDERS`, and with the f32 rounding of the kernel's
epilogue (:func:`_kernel_epilogue_mlp`; ``--orders`` picks among them;
``kernel``, with ``--device cuda``: the fused kernel itself),
each held to the plain version's own and to the exact one (``f64_solve``,
else ``f64``), and the kernel to each of the others: rvm's mean, max, worst lane and
0.9 quantile over lanes, ``snap_lanes``, the share of lanes whose
snapshots move by more than :data:`LANE_TOL`, and the median and 0.9
quantile over lanes of each lane's largest diff (every lane's in the
file, ``lane_max``); rows in ``DIR/sum_order.json``.
``eval-sum-order`` (the card by default): the plain version's
``--repeats``-repeat sampled evaluation over ``--iters`` subgame
iterations at ``--game`` with bf16 operands, with the MLP's sums in f32
and exact in f64, for each of ``--solvers``; rows in
``DIR/eval_sum_order.json``.  ``same-bits`` (card only): ``--old`` is
``rebel_tpu_torch/kernels/grid2_cfr.cu`` inside a checkout of another
version of the port (e.g. ``git archive c7fda4d rebel_tpu_torch | tar -x
-C _parent``); each version's own package builds its kernel, chooses its
lane block and ``mlp_chunks`` and launches it on the same seeded inputs
(:data:`SAME_BITS`: 1x4f and 2x3f, CFR and FP, bf16 and f32 operands with
the repo's trained net, no net, and ``interleave=2`` at 1x4f; 1024 lanes,
1024 iterations), in processes taken in turns (:data:`SAME_BITS_TURNS`);
the three outputs are compared with ``torch.equal`` and each mode's
launch is timed for both versions on the one card (``ms_old``,
``ms_tree``); rows in ``DIR/same_bits.json``.  ``same-bits --large``
(card only, some 8 minutes): the same at :data:`SAME_BITS_LARGE`, the
games whose launches keep arrays in the device workspace (2x5f, 3x3f,
2x6f, 3x4f and 1x16f, CFR and FP, bf16 and f32 operands, the fresh 256x2
nets of ``chip_smoke.py large-games``, made once by this checkout's
``mlp_breakdown.large_net`` and loaded by both versions; 1024 lanes, 1024
iterations), each version's launch warmed up by one of 4 iterations and
then timed once a process, with the card's name and power limit on every
row; ``--cells '2x5 cfr f32' ...`` takes only those; rows in
``DIR/same_bits_large.json``.  ``launches`` (the CPU, about
ten minutes): how many launches of the fused solve a sampled evaluation
makes at each game of ``eval_all``'s defaults, counted from the code
(the frontier solver's chunks, each one launch on the card, with the
lane block the wrapper chooses there): the paper protocol's
1024 repeats and the trainer's ``eval_num_repeats`` (8, the in-training
``exploitability_avg``, which runs the kernel with an f32 MLP); the count
depends on neither the net nor the subgame iterations, so it runs
without a net over one iteration; rows in ``DIR/launches.json``.
``plain-ms`` (card only, some ten minutes): the plain version's time
(``grid2p.solve_reference``) at the modes of PERF.md's kernel table that
lack it (:data:`PLAIN_MODES`; ``--large``: :data:`PLAIN_LARGE_MODES`,
2x5f to 3x4f with the fresh nets of ``chip_smoke.py large-games``;
``--wide``: :data:`PLAIN_WIDE_MODES`, 512x2 and 384x2 at 1x4f;
``--hands128``: :data:`PLAIN_HANDS128_MODES`, 4x3f, 2x9f and 2x10f at 264
lanes; with
``--kernel``, the kernel's time on the same inputs); rows in
``DIR/plain_ms.json``.  ``bounds`` (card only, some 5 minutes with its
build): the index-checked build of the workspace instantiations
(``kernels/build.py`` ``load_checked``: every index into a part of the
workspace or of shared memory checked, a trap that prints the part, block,
thread and index where one leaves it; its two-group instantiations call
the body's phases as the one-group ones do) on every game of
``chip_smoke.py large-games`` (:data:`BOUNDS_GAMES`), CFR and FP, bf16 and
f32, the fresh 256x2 nets, at every workspace level ``_force_workspace``
reaches whose layout fits (and ``interleave=2`` at the games of up to 64
hands; at 1x4f and 2x6f also at level 4 on 256 lanes x 1024 iterations,
:data:`BOUNDS_LONG`), :data:`BOUNDS_LANES` lanes x :data:`BOUNDS_ITERS`
iterations, each
launch held bit for bit to the unchecked build's launch at the chosen
layout; a game a process (a trap ends its process); then the
``bytes stack frame`` of every function of both builds (``-Xptxas -v``);
rows in ``DIR/bounds.json``.
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
# sum-order's plain versions: ORDERS, the kernel's epilogue rounding, and
# (f32 operands) the whole solve in f64; and (on the card) the kernel.
SUM_ORDERS = [*ORDERS, "kernel_epilogue", "f64_solve", "kernel"]
# chip_smoke.py's LANE_TOL: a lane whose snapshots differ anywhere by more
# is counted in sum-order's ``snap_lanes``, as the check counts it.
LANE_TOL = 0.05


def _fma(a, b, c):
    """a * b + c rounded once to f32 (through f64, where the product is
    exact)."""
    return (a.double() * b.double() + c.double()).float()


# grid2_cfr.cu gelu_fast's coefficients, highest power first.
_GELU_POLY = (1.40787036032954e-05, -0.00034346830302456875,
              0.0037230956091636926, -0.024381732600758942,
              0.11078739955649257, -0.37547712975483916,
              1.1283452779263845)


def _f64_mlp(net):
    """The plain version's f32 MLP (``grid2p.kernel_mlp`` with f32
    operands: one-pass LayerNorm, the exact-erf GELU) in f64 throughout."""
    import copy

    from rebel_tpu_torch.solving import grid2p

    net = copy.deepcopy(net).double()

    def mlp(x):
        x = x.double().T
        for lin, ln in net.hidden_layers():
            x = x @ lin.weight.T + lin.bias
            if ln is not None:
                mu = x.mean(-1, keepdim=True)
                var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0)
                r = (var + 1e-5).rsqrt()
                x = (x * r - mu * r) * ln.weight + ln.bias
            x = grid2p.gelu_erf(x)
        return (x @ net.output.weight.T + net.output.bias).T

    return mlp


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
                cols = x.view(n, -1, 4, 2)
                s = x.new_zeros(n, 4)
                q = x.new_zeros(n, 4)
                for m in range(cols.shape[1]):
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


# same-bits: (game, solver, MLP operands: "bf16", "f32" or "none" for no
# net, interleave), each over SAME_BITS_LANES lanes and SAME_BITS_ITERS
# iterations from SAME_BITS_SEED.  Each version runs in SAME_BITS_RUNS
# processes in turns (old, tree, tree, old); a process launches every mode
# once for its outputs, then SAME_BITS_TIMED times, timed with CUDA events.
SAME_BITS_LANES, SAME_BITS_ITERS, SAME_BITS_SEED = 1024, 1024, 17
SAME_BITS_TIMED = 2
SAME_BITS_TURNS = ("old", "tree", "tree", "old")
SAME_BITS = [((nd, nf), solver, dtype, 1)
             for nd, nf in ((1, 4), (2, 3)) for solver in ("cfr", "fp")
             for dtype in ("bf16", "f32", "none")]
SAME_BITS += [((1, 4), "cfr", dtype, 2) for dtype in ("bf16", "f32")]
# The tree's bf16 ring beside its resident weights on the same inputs:
# (game, solver, lane block), each against the mode of SAME_BITS with the
# same game and solver in bf16.
SAME_BITS_RING = [((2, 3), "cfr", 4), ((2, 3), "fp", 4)]
# same-bits --large: the workspace games, (game, solver, operands, 1).
SAME_BITS_LARGE = [((nd, nf), solver, dtype, 1)
                   for nd, nf in ((2, 5), (3, 3), (2, 6), (3, 4), (1, 16))
                   for solver in ("cfr", "fp") for dtype in ("bf16", "f32")]


def _timed(solve) -> tuple:
    """``(solve()'s outputs on the CPU, ms)``, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = solve()
    end.record()
    end.synchronize()
    return [x.cpu() for x in out], start.elapsed_time(end)


def same_bits_launch(args) -> list[dict]:
    """One process of ``same-bits``: every mode through the package under
    ``--root`` (this checkout's or another's), outputs and times saved to
    ``--out`` (a ``torch.save`` file)."""
    import torch

    import rebel_tpu_torch
    from rebel_tpu_torch.eval.recursive_eval import _load_net
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.nets.cfv_net import CFVNet
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    if not pathlib.Path(rebel_tpu_torch.__file__).resolve().is_relative_to(
            args.root.resolve()):
        raise SystemExit(f"imported {rebel_tpu_torch.__file__}, not the "
                         f"package under {args.root}")
    dev = torch.device("cuda")
    lanes, iters = SAME_BITS_LANES, SAME_BITS_ITERS
    rows = []
    if args.large:
        states = torch.load(args.nets)
        for (nd, nf), solver, dtype, _ in SAME_BITS_LARGE:
            if args.cells and f"{nd}x{nf} {solver} {dtype}" not in args.cells:
                continue
            game = LiarsDice(nd, nf)
            A, H = game.num_actions, game.num_hands
            g = torch.Generator().manual_seed(SAME_BITS_SEED)
            expo = -torch.log(torch.rand((lanes, 2, H), generator=g))
            inputs = [torch.randint(-1, A - 1, (lanes,), generator=g),
                      torch.randint(0, 2, (lanes,), generator=g),
                      expo / expo.sum(-1, keepdim=True),
                      torch.randint(0, iters + 1, (lanes,), generator=g)]
            net = CFVNet(game, 256, 2, True)
            net.load_state_dict(states[nd, nf])
            net = net.to(dev)
            call = lambda n: grid2p.solve(
                game, SubgameSolvingParams(num_iters=n, max_depth=2,
                                           use_cfr=solver == "cfr",
                                           linear_update=True),
                *[x.to(dev) for x in inputs[:3]],
                torch.clamp(inputs[3], max=n).to(dev), net,
                torch.float32 if dtype == "f32" else torch.bfloat16)
            call(4)
            out, ms = _timed(lambda: call(iters))
            rows.append(dict(game=f"{nd}x{nf}", solver=solver, mlp=dtype,
                             interleave=1, lanes=lanes, iters=iters,
                             lane_block=grid2p.solve.last_lane_block,
                             layout=grid2p.solve.last_layout, ms=[ms],
                             out=out))
        torch.save(rows, args.out)
        return rows
    for (nd, nf), solver, dtype, interleave in SAME_BITS:
        game = LiarsDice(nd, nf)
        A, H = game.num_actions, game.num_hands
        g = torch.Generator().manual_seed(SAME_BITS_SEED)
        expo = -torch.log(torch.rand((lanes, 2, H), generator=g))
        inputs = [torch.randint(-1, A - 1, (lanes,), generator=g),
                  torch.randint(0, 2, (lanes,), generator=g),
                  expo / expo.sum(-1, keepdim=True),
                  torch.randint(0, iters + 1, (lanes,), generator=g)]
        net = (None if dtype == "none" else
               _load_net(str(ROOT / NETS[(nd, nf), solver]), game, "cuda")[1])
        sub = SubgameSolvingParams(num_iters=iters, max_depth=2,
                                   use_cfr=solver == "cfr",
                                   linear_update=True)
        call = (game, sub, *[x.to(dev) for x in inputs], net,
                torch.float32 if dtype == "f32" else torch.bfloat16)
        out = [x.cpu() for x in grid2p.solve(*call, interleave=interleave)]
        times = []
        for _ in range(SAME_BITS_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            grid2p.solve(*call, interleave=interleave)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rows.append(dict(game=f"{nd}x{nf}", solver=solver, mlp=dtype,
                         interleave=interleave, lanes=lanes, iters=iters,
                         lane_block=grid2p.solve.last_lane_block,
                         ms=times, out=out))
        for ring_game, ring_solver, lane_block in (
                SAME_BITS_RING if args.ring else ()):
            if ((nd, nf), solver, dtype, interleave) != (
                    ring_game, ring_solver, "bf16", 1):
                continue
            out = [x.cpu() for x in grid2p.solve(*call,
                                                 lane_block=lane_block)]
            times = []
            for _ in range(SAME_BITS_TIMED):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                grid2p.solve(*call, lane_block=lane_block)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            rows.append(dict(rows[-1], lane_block=lane_block, ring=True,
                             ms=times, out=out))
    torch.save(rows, args.out)
    return rows


def same_bits(args) -> list[dict]:
    """Runs ``same_bits_launch`` for the version around ``--old`` and for
    this checkout in SAME_BITS_TURNS, and compares the first processes'
    outputs with ``torch.equal`` (and each version's outputs across its
    own processes: the kernel is deterministic)."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("same-bits runs on the card only")
    old_root = args.old.resolve().parents[2]
    if args.old.resolve() != (old_root / "rebel_tpu_torch" / "kernels"
                              / "grid2_cfr.cu"):
        raise SystemExit(f"--old must be rebel_tpu_torch/kernels/"
                         f"grid2_cfr.cu inside a checkout of another "
                         f"version, not {args.old}")
    roots = {"old": old_root, "tree": ROOT}
    runs = {"old": [], "tree": []}
    large = []
    if args.large:
        # The fresh nets, made once by this checkout's package and loaded
        # by both versions'.
        from rebel_tpu_torch.games.liars_dice import LiarsDice
        from rebel_tpu_torch.mlp_breakdown import large_net

        nets = args.out.resolve() / "large_nets.pt"
        torch.save({game: large_net(LiarsDice(*game)).state_dict()
                    for game in dict.fromkeys(g for g, *_ in SAME_BITS_LARGE)},
                   nets)
        large = ["--large", "--nets", str(nets)] + (
            ["--cells", *args.cells] if args.cells else [])
    for i, version in enumerate(SAME_BITS_TURNS):
        path = args.out.resolve() / f"same_bits_{version}_{i}.pt"
        subprocess.run([sys.executable, str(ROOT / "chip_studies.py"),
                        "same-bits-launch", "--root", str(roots[version]),
                        "--out", str(path)]
                       + (large if args.large else
                          ["--ring"] if version == "tree" else []),
                       cwd=roots[version], check=True)
        runs[version].append(torch.load(path))
        path.unlink()
    from rebel_tpu_torch.bench import card_name_and_power_limit

    card = card_name_and_power_limit()
    rows = []
    tree_rows = [r for r in runs["tree"][0] if not r.get("ring")]
    for k, old in enumerate(runs["old"][0]):
        tree = tree_rows[k]
        row = {key: old[key] for key in ("game", "solver", "mlp",
                                         "interleave", "lanes", "iters")}
        row.update(card=card, lane_block_old=old["lane_block"],
                   lane_block_tree=tree["lane_block"])
        if args.large:
            row.update(layout_old=old["layout"], layout_tree=tree["layout"])
        for version, got in runs.items():
            if version == "tree":
                got = [[r for r in run if not r.get("ring")] for run in got]
            ms = [t for run in got for t in run[k]["ms"]]
            row[f"ms_{version}"] = sum(ms) / len(ms)
            row[f"{version}_repeats_equal"] = all(
                torch.equal(x, y) for run in got[1:]
                for x, y in zip(got[0][k]["out"], run[k]["out"]))
        for key, a, b in zip(("rvm", "snap0", "snap1"), old["out"],
                             tree["out"]):
            row[key] = dict(
                equal=bool(torch.equal(a, b)),
                max_abs_diff=float((a - b).abs().max()),
                lanes_differing=int((a != b).flatten(1).any(1).sum()))
        row["equal"] = all(row[k]["equal"] for k in ("rvm", "snap0", "snap1"))
        row["speedup"] = row["ms_old"] / row["ms_tree"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    # The ring beside the resident weights, in the tree's processes.
    for j, ring in enumerate(runs["tree"][0]):
        if not ring.get("ring"):
            continue
        resident = runs["tree"][0][j - 1]
        ms = [t for run in runs["tree"] for t in run[j]["ms"]]
        ms_resident = [t for run in runs["tree"] for t in run[j - 1]["ms"]]
        row = {key: ring[key] for key in ("game", "solver", "mlp", "lanes",
                                          "iters")}
        row.update(lane_block_ring=ring["lane_block"],
                   lane_block_resident=resident["lane_block"],
                   ms_ring=sum(ms) / len(ms),
                   ms_resident=sum(ms_resident) / len(ms_resident),
                   equal=all(torch.equal(x, y) for x, y in
                             zip(ring["out"], resident["out"])))
        rows.append(row)
        print(json.dumps(row), flush=True)
    (args.out / ("same_bits_large.json" if args.large
                 else "same_bits.json")).write_text(json.dumps(rows, indent=1))
    return rows


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

    from rebel_tpu_torch.nets.cfv_net import CFVNet

    nd, nf = (int(x) for x in args.game.split("x"))
    game = LiarsDice(nd, nf)
    if not args.fresh and (nd, nf) not in FP_NETS:
        raise SystemExit(f"sum-order at {args.game} needs --fresh: the repo "
                         "has no trained net of that game")
    if args.fresh:
        # chip_smoke.py's fresh_net(layers, use_ln, seed, seeded_ln=True,
        # width) of its widths phase.
        width, layers = (int(x) for x in args.fresh.split("x"))
        g = torch.Generator().manual_seed(args.net_seed)
        net = CFVNet(game, width, layers, not args.noln, generator=g)
        with torch.no_grad():
            for _, ln in net.hidden_layers():
                if ln is not None:
                    ln.weight.copy_(0.5 + torch.rand(width, generator=g))
                    ln.bias.copy_(torch.rand(width, generator=g) - 0.5)
        net = net.to(args.device)
    else:
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
                                  use_cfr=args.solver == "cfr",
                                  linear_update=True)
    operands = torch.bfloat16 if args.operands == "bf16" else torch.float32
    plain = grid2p.kernel_mlp(net, operands)
    outs = {}
    for name in args.orders:
        if name == "kernel_epilogue":
            outs[name] = grid2p.solve_loop(game, params, *inputs,
                                           _kernel_epilogue_mlp(net))
            continue
        if name == "kernel":
            outs[name] = grid2p.solve(game, params, *inputs, net, operands)
            continue
        if name == "f64_solve":
            outs[name] = grid2p.Grid2Outputs(*(x.float() for x in (
                grid2p.solve_loop(game, params, *inputs[:2],
                                  inputs[2].double(), inputs[3],
                                  _f64_mlp(net), dtype=torch.float64))))
            continue

        def mlp(x, matmul=ORDERS[name]):
            if matmul is None:
                return plain(x)
            with _products(matmul):
                return plain(x)
        outs[name] = grid2p.solve_loop(game, params, *inputs, mlp)
    pairs = [("f32", o) for o in outs if o != "f32"]
    if "tc_chained" in outs and "tc_steps" in outs:
        pairs.append(("tc_chained", "tc_steps"))
    # Each version also held to the exact one: the whole solve in f64 (f32
    # operands) or the MLP's sums exact (bf16).
    exact = next((o for o in ("f64_solve", "f64") if o in outs), None)
    pairs += [(exact, o) for o in outs if exact and o not in ("f32", exact)]
    # ... and the kernel to each of the other plain versions.
    pairs += [(o, "kernel") for o in outs if "kernel" in outs
              and o not in ("f32", exact, "kernel")]
    rows = []
    for a, b in pairs:
        rvm = (outs[a].rvm - outs[b].rvm).abs().flatten(1).amax(1)
        snap = torch.maximum(
            (outs[a].snap0 - outs[b].snap0).abs().flatten(1).amax(1),
            (outs[a].snap1 - outs[b].snap1).abs().flatten(1).amax(1))
        lane = torch.maximum(rvm, snap)  # each lane's largest diff
        rows.append(dict(game=args.game, solver=args.solver,
                         net=(args.fresh or "trained")
                         + (" noln" if args.noln else ""),
                         operands=args.operands, iters=args.iters,
                         lanes=B, seed=args.seed, pair=f"{a}-{b}",
                         max_abs_diff=max(float((x - y).abs().max())
                                          for x, y in zip(outs[a], outs[b])),
                         rvm_mean=float((outs[a].rvm - outs[b].rvm).abs()
                                        .mean()),
                         rvm_max=float(rvm.max()),
                         worst_lane=int(rvm.argmax()),
                         lanes_rvm_over_1e3=int((rvm > 1e-3).sum()),
                         lane_rvm_q90=float(rvm.quantile(0.9)),
                         snap_lanes=float((snap > LANE_TOL).float().mean()),
                         lane_q50=float(lane.quantile(0.5)),
                         lane_q90=float(lane.quantile(0.9)),
                         worst_lane_all=int(lane.argmax())))
        print(json.dumps(rows[-1]), flush=True)
        rows[-1]["lane_max"] = lane.cpu().tolist()
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


# launches: (game, repeats); the trainer's default eval_num_repeats is 8.
LAUNCH_GAMES = ((1, 4), (1, 5), (1, 6), (2, 3))
LAUNCH_REPEATS = (1024, 8)


# plain-ms: the modes of PERF.md's kernel table without the plain
# version's time: (game, solver, MLP: "bf16", "f32" or "none", net shape
# (width, hidden layers)), each at 1024 lanes x 1024 iterations from the
# same seed, with the repo's trained net of the game and solver at 256x2,
# else a net from a seed.
PLAIN_MODES = [((nd, nf), solver, mlp, (256, 2))
               for nd, nf in ((1, 5), (1, 6), (2, 3))
               for solver in ("cfr", "fp") for mlp in ("bf16", "f32")]
PLAIN_MODES += [((1, 4), solver, mlp, (256, 2))
                for solver in ("cfr", "fp") for mlp in ("f32", "none")]
PLAIN_MODES += [((1, 4), "cfr", "bf16", (256, 3)),
                ((1, 4), "cfr", "bf16", (32, 2)),
                ((1, 4), "cfr", "f32", (32, 2))]
# plain-ms --large: the games of up to 64 hands and actions, with the
# fresh 256x2 nets of chip_smoke.py's large-games phase
# (mlp_breakdown.LARGE_NET_SEEDS).
PLAIN_LARGE_MODES = [((nd, nf), solver, mlp, (256, 2))
                     for nd, nf in ((2, 5), (3, 3), (2, 6), (3, 4))
                     for solver in ("cfr", "fp") for mlp in ("bf16", "f32")]
# plain-ms --wide: the nets of the wide units (padded width 512) at 1x4f,
# as chip_smoke.py's widths phase times them (WIDTH_TIMED).
PLAIN_WIDE_MODES = [((1, 4), solver, mlp, (512, 2))
                    for solver in ("cfr", "fp") for mlp in ("bf16", "f32")]
PLAIN_WIDE_MODES += [((1, 4), "cfr", "bf16", (384, 2))]
# plain-ms --hands128: the games of 65-128 hands with the fresh nets of
# chip_smoke.py large-games, at the lanes its timed launches take there
# (HANDS128_TIMED_LANES).
PLAIN_HANDS128_MODES = [((nd, nf), solver, mlp, (256, 2))
                        for nd, nf in ((4, 3), (2, 9), (2, 10))
                        for solver in ("cfr", "fp") for mlp in ("bf16", "f32")]
PLAIN_HANDS128_LANES = 264
GAME_NETS = {**NETS, ((1, 5), "fp"): FP_NETS[1, 5],
             ((1, 6), "cfr"): "results/liars_sp/r5_1x6cfr/ckpt/epoch990.params",
             ((1, 6), "fp"): FP_NETS[1, 6]}


def plain_ms(args) -> list[dict]:
    """The plain version's time (``grid2p.solve_reference``, CUDA events,
    one run after a run of 4 iterations) at PLAIN_MODES, on the card."""
    import torch

    from rebel_tpu_torch.bench import card_name_and_power_limit
    from rebel_tpu_torch.eval.recursive_eval import _load_net
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.mlp_breakdown import LARGE_NET_SEEDS, large_net
    from rebel_tpu_torch.nets.cfv_net import CFVNet
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    if not torch.cuda.is_available():
        raise SystemExit("plain-ms runs on the card only")
    dev = torch.device("cuda")
    card = card_name_and_power_limit()
    rows = []
    lanes = PLAIN_HANDS128_LANES if args.hands128 else 1024
    large = args.large or args.hands128
    for (nd, nf), solver, mlp, (width, layers) in (
            PLAIN_LARGE_MODES if args.large
            else PLAIN_HANDS128_MODES if args.hands128
            else PLAIN_WIDE_MODES if args.wide else PLAIN_MODES):
        game = LiarsDice(nd, nf)
        A, H = game.num_actions, game.num_hands
        g = torch.Generator().manual_seed(SAME_BITS_SEED)
        expo = -torch.log(torch.rand((lanes, 2, H), generator=g))
        inputs = [torch.randint(-1, A - 1, (lanes,), generator=g),
                  torch.randint(0, 2, (lanes,), generator=g),
                  expo / expo.sum(-1, keepdim=True),
                  torch.randint(0, 1025, (lanes,), generator=g)]
        net = None
        path = GAME_NETS[(nd, nf), solver] if (width, layers) == (256, 2) \
            and not large else f"{width}x{layers} from a seed"
        if large:
            seed = LARGE_NET_SEEDS[nd, nf]
            path = f"256x2 from seed {seed}, LayerNorm drawn"
            net = large_net(game, seed).to(dev)
        elif mlp != "none":
            if (width, layers) == (256, 2):
                net = _load_net(str(ROOT / path), game, "cuda")[1]
            else:
                net = CFVNet(game, width, layers, True,
                             generator=torch.Generator().manual_seed(5)
                             ).to(dev)
        dtype = torch.float32 if mlp == "f32" else torch.bfloat16
        solve = grid2p.solve if args.kernel else grid2p.solve_reference
        call = lambda iters: solve(
            game, SubgameSolvingParams(num_iters=iters, max_depth=2,
                                       use_cfr=solver == "cfr",
                                       linear_update=True),
            *[x.to(dev) for x in inputs[:3]],
            torch.clamp(inputs[3], max=iters).to(dev), net, dtype)
        call(4)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(1024)
        end.record()
        end.synchronize()
        rows.append(dict(card=card, game=f"{nd}x{nf}", solver=solver,
                         mlp=mlp, net=path if net is not None else None,
                         lanes=lanes, iters=1024))
        if args.kernel:
            rows[-1].update(kernel_ms=start.elapsed_time(end),
                            lane_block=grid2p.solve.last_lane_block,
                            layout=grid2p.solve.last_layout)
        else:
            rows[-1]["plain_ms"] = start.elapsed_time(end)
        print(json.dumps(rows[-1]), flush=True)
    (args.out / "plain_ms.json").write_text(json.dumps(rows, indent=1))
    return rows


def launches(args) -> list[dict]:
    """The fused solve's launches of a sampled evaluation: the kernel
    engine's frontier solver on the CPU (its plain version), with every
    chunk it solves counted, each of which the card solves in one launch
    (padded to the lane block)."""
    import torch

    from rebel_tpu_torch.eval import recursive, recursive_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    count = {"n": 0}
    solve_chunk = recursive.Grid2FrontierSolver._solve_chunk

    def counted(self, *a):
        count["n"] += 1
        return solve_chunk(self, *a)

    recursive.Grid2FrontierSolver._solve_chunk = counted
    rows = []
    try:
        for nd, nf in LAUNCH_GAMES:
            game = LiarsDice(nd, nf)
            for use_cfr in (True, False):
                sub = SubgameSolvingParams(num_iters=1, max_depth=2,
                                           use_cfr=use_cfr,
                                           linear_update=True)
                for repeats in LAUNCH_REPEATS:
                    count["n"] = 0
                    t0 = time.perf_counter()
                    recursive_eval.sampled_eval(
                        game, sub, None, repeats, None,
                        dtype=torch.float32, progress=False,
                        engine="kernel", device="cpu")
                    row = dict(game=f"{nd}x{nf}",
                               solver="cfr" if use_cfr else "fp",
                               repeats=repeats, launches=count["n"],
                               seconds=time.perf_counter() - t0)
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    finally:
        recursive.Grid2FrontierSolver._solve_chunk = solve_chunk
    (args.out / "launches.json").write_text(json.dumps(rows, indent=1))
    return rows


# bounds: the games of chip_smoke.py large-games, lanes and iterations.
BOUNDS_GAMES = ("1x4", "2x3", "2x5", "3x3", "2x6", "3x4", "1x16", "4x3",
                "2x9", "2x10")
BOUNDS_LANES = 16
BOUNDS_ITERS = 6
# ... and, where the two-group calls once faulted, chip_smoke.py's
# WORKSPACE_BITS launches of grid2_cfr_il2, at level 4: lanes and
# iterations.
BOUNDS_LONG = {"1x4": (256, 1024), "2x6": (256, 1024)}


def bounds_game(args) -> list[dict]:
    """One game of ``bounds`` (a process of its own): every case on the
    index-checked build, against the unchecked build's bits."""
    import torch

    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.mlp_breakdown import large_net
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    from rebel_tpu_torch.mlp_breakdown import LARGE_NET_SEEDS

    nd, nf = map(int, args.game.split("x"))
    game = LiarsDice(nd, nf)
    dev = torch.device("cuda")
    # chip_smoke.py's WORKSPACE_BITS net where the game has no seed of its
    # own.
    net = large_net(game, LARGE_NET_SEEDS.get((nd, nf), 361)).to(dev)

    def inputs_of(B, T):
        g = torch.Generator().manual_seed(400 + nd * 32 + nf)
        expo = -torch.log(torch.rand((B, 2, game.num_hands), generator=g))
        return [x.to(dev) for x in (
            torch.randint(-1, game.num_actions - 1, (B,), generator=g),
            torch.randint(0, 2, (B,), generator=g),
            expo / expo.sum(-1, keepdim=True),
            torch.randint(0, T + 1, (B,), generator=g))]

    rows = []
    if args.game in BOUNDS_LONG:
        B, T = BOUNDS_LONG[args.game]
        sub = SubgameSolvingParams(num_iters=T, max_depth=2,
                                   linear_update=True, use_cfr=True)
        args_ = (game, sub, *inputs_of(B, T), net, torch.bfloat16)
        plain = grid2p.solve(*args_)
        row = dict(game=args.game, solver="cfr", operands="bf16",
                   interleave=2, level=grid2p.WS_BODY, lanes=B, iters=T)
        print(json.dumps(dict(row, starting=True)), flush=True)
        with grid2p._force_workspace(grid2p.WS_BODY):
            out = grid2p.solve(*args_, interleave=2, index_checked=True)
            torch.cuda.synchronize()
            row.update(lane_block=grid2p.solve.last_lane_block,
                       layout=grid2p.solve.last_layout,
                       result="no check fired",
                       same_bits=all(torch.equal(x, y)
                                     for x, y in zip(out, plain)))
        rows.append(row)
        print(json.dumps(row), flush=True)
    B, T = BOUNDS_LANES, BOUNDS_ITERS
    inputs = inputs_of(B, T)
    for solver in ("cfr", "fp"):
        sub = SubgameSolvingParams(num_iters=T, max_depth=2,
                                   linear_update=True,
                                   use_cfr=solver == "cfr")
        for dname, dtype in (("bf16", torch.bfloat16),
                             ("f32", torch.float32)):
            args_ = (game, sub, *inputs, net, dtype)
            plain = grid2p.solve(*args_)  # the unchecked build's default
            ils = (1, 2) if solver == "cfr" and game.num_hands <= \
                grid2p.MAX_ROW else (1,)
            bf16 = dtype == torch.bfloat16
            for il in ils:
                for level in range(1, grid2p.max_workspace(2, bf16, il) + 1):
                    row = dict(game=args.game, solver=solver, operands=dname,
                               interleave=il, level=level)
                    with grid2p._force_workspace(level):
                        try:
                            lb = grid2p.choose_lane_block(
                                game, sub, net, dtype, B, il)
                            print(json.dumps(dict(row, starting=lb)),
                                  flush=True)
                            out = grid2p.solve(*args_, interleave=il,
                                               index_checked=True)
                        except ValueError as e:
                            row.update(result="does not fit", why=str(e))
                            rows.append(row)
                            print(json.dumps(row), flush=True)
                            continue
                        torch.cuda.synchronize()
                        row.update(lane_block=lb,
                                   layout=grid2p.solve.last_layout)
                    row.update(result="no check fired",
                               same_bits=all(torch.equal(x, y) for x, y in
                                             zip(out, plain)))
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


def bounds(args) -> list[dict]:
    """The index-checked build on every game (a process each), then the
    stack frames of both builds' functions."""
    import subprocess

    from rebel_tpu_torch.kernels import build

    rows = []
    for game in args.games:
        proc = subprocess.run(
            [sys.executable, __file__, "bounds-game", "--game", game,
             "--out", str(args.out)], capture_output=True, text=True)
        out = proc.stdout + proc.stderr
        got = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith("{") and "result" in x]
        faults = [x for x in out.splitlines() if "index check" in x
                  or "Error" in x or "error" in x]
        print(f"bounds {game}: exit {proc.returncode}, {len(got)} cases, "
              f"{sum(r['result'] == 'no check fired' for r in got)} ran, "
              f"{sum(not r.get('same_bits', True) for r in got)} with other "
              "bits", flush=True)
        for x in faults[:40]:
            print(f"    {x}", flush=True)
        if proc.returncode:
            started = [json.loads(x) for x in proc.stdout.splitlines()
                       if '"starting"' in x]
            print(f"    the last case started: {started[-1:]}", flush=True)
        rows += got + [dict(game=game, exit=proc.returncode,
                            faults=faults[:40])]
    for label, defines in (("unchecked", ()),
                           ("checked", (build.CHECK_INDEX,))):
        path = build.library_path("grid2_cfr", defines, None if not defines
                                  else build.CHECKED_UNITS)
        log = path.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        fn = None
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "bytes stack frame" in line and fn and (
                    "ws_" in fn or "grid2_kernel" in fn):
                frame = int(line.split("bytes stack frame")[0].split()[-1])
                if frame or "ws_" in fn:
                    rows.append(dict(build=label, function=fn,
                                     properties=line.strip()))
                    print(f"stack {label} {fn}: {line.strip()}", flush=True)
    (args.out / "bounds.json").write_text(json.dumps(rows, indent=1))
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
                   choices=["1x4"] + [f"{nd}x{nf}" for nd, nf in FP_NETS]
                   + ["2x5", "3x3", "2x6", "3x4", "1x16", "4x3", "2x9",
                      "2x10"],
                   help="the larger games (2x5 and on) with --fresh only")
    o.add_argument("--fresh", default=None, metavar="WIDTHxLAYERS",
                   help="a fresh net from --net-seed, as chip_smoke.py's "
                        "widths phase makes it, instead of the trained FP "
                        "net")
    o.add_argument("--net-seed", type=int, default=0)
    o.add_argument("--noln", action="store_true",
                   help="the fresh net without LayerNorm")
    o.add_argument("--orders", nargs="+", default=SUM_ORDERS[:-2],
                   choices=SUM_ORDERS,
                   help="the plain versions to run (f32 first: each other "
                        "is held to it)")
    o.add_argument("--solver", default="fp", choices=["fp", "cfr"])
    o.add_argument("--seed", type=int, default=62)
    o.add_argument("--lanes", type=int, default=256)
    o.add_argument("--iters", type=int, default=64)
    o.add_argument("--device", default="cpu")
    o.add_argument("--operands", default="bf16", choices=["bf16", "f32"],
                   help="the MLP's operands (f32: the orders f32, f64, "
                        "f64_solve and kernel only)")
    e = sub.add_parser("eval-sum-order")
    e.add_argument("--out", type=pathlib.Path, required=True)
    e.add_argument("--game", default="2x3", choices=["1x4", "2x3"])
    e.add_argument("--solvers", nargs="+", default=["fp", "cfr"],
                   choices=["fp", "cfr"])
    e.add_argument("--repeats", type=int, default=4)
    e.add_argument("--iters", type=int, default=1024)
    e.add_argument("--device", default="cuda")
    b = sub.add_parser("same-bits")
    b.add_argument("--old", type=pathlib.Path, required=True)
    b.add_argument("--out", type=pathlib.Path, required=True)
    b.add_argument("--large", action="store_true",
                   help="the workspace games (SAME_BITS_LARGE) in place of "
                        "SAME_BITS")
    b.add_argument("--cells", nargs="+", default=None,
                   help="with --large: only these cells, e.g. '2x5 cfr f32'")
    n = sub.add_parser("launches")
    n.add_argument("--out", type=pathlib.Path, required=True)
    pm = sub.add_parser("plain-ms")
    pm.add_argument("--out", type=pathlib.Path, required=True)
    pm.add_argument("--large", action="store_true",
                    help="the games of up to 64 hands and actions "
                         "(PLAIN_LARGE_MODES) in place of PLAIN_MODES")
    pm.add_argument("--hands128", action="store_true",
                    help="the games of 65-128 hands (PLAIN_HANDS128_MODES, "
                         "264 lanes) in place of PLAIN_MODES")
    pm.add_argument("--wide", action="store_true",
                    help="the nets of 384 and 512 on the wide units at 1x4f "
                         "(PLAIN_WIDE_MODES) in place of PLAIN_MODES")
    pm.add_argument("--kernel", action="store_true",
                    help="time the kernel (grid2p.solve) on the same inputs "
                         "in place of the plain version")
    bd = sub.add_parser("bounds")
    bd.add_argument("--out", type=pathlib.Path, required=True)
    bd.add_argument("--games", nargs="+", default=list(BOUNDS_GAMES),
                    choices=BOUNDS_GAMES)
    bg = sub.add_parser("bounds-game")
    bg.add_argument("--game", required=True, choices=BOUNDS_GAMES)
    bg.add_argument("--out", type=pathlib.Path, required=True)
    bl = sub.add_parser("same-bits-launch")
    bl.add_argument("--root", type=pathlib.Path, required=True)
    bl.add_argument("--out", type=pathlib.Path, required=True)
    bl.add_argument("--ring", action="store_true")
    bl.add_argument("--large", action="store_true")
    bl.add_argument("--nets", type=pathlib.Path)
    bl.add_argument("--cells", nargs="+", default=None)
    args = ap.parse_args(argv)
    if args.study == "same-bits-launch":
        sys.path.insert(0, str(args.root))
        return same_bits_launch(args)
    sys.path.insert(0, str(ROOT))
    args.out.mkdir(parents=True, exist_ok=True)
    study = {"drift": drift, "f32-ladder": f32_ladder,
             "sum-order": sum_order,
             "eval-sum-order": eval_sum_order,
             "same-bits": same_bits, "launches": launches,
             "plain-ms": plain_ms, "bounds": bounds,
             "bounds-game": bounds_game}[args.study]
    return study(args)


if __name__ == "__main__":
    main()
