"""Where a launch of the fused solve spends its time, on the card.

    python -m rebel_tpu_torch.mlp_breakdown [--rounds 2] [--batch 1024]
        [--parts mlp,mlp32,body,ring16,large]

Builds ``kernels/grid2_cfr.cu`` with parts taken out (``-DBREAKDOWN=`` a
mask of the source's ``CUT_*`` switches, :data:`CUTS`) beside the build as
it is, all at once, and times one launch of each with CUDA events, in
rounds (every variant once per round).  A variant's results are wrong by
construction: only its time means something.  Prints one JSON line per
reading.

* ``mlp``: the parts of the bf16 MLP stage (the wgmma products, the f32
  epilogue of the hidden layers, the head) at the :data:`MLP_CELLS`:
  1x4f and 2x3f for CFR and FP and 1x6f for FP, each at the lane block
  the wrapper chooses (256x2 net with LayerNorm, random weights from a
  seed, ``--batch`` lanes, 1024 iterations); then the whole kernel at
  1x4f with the ablations and without a net.
* ``mlp32``: the parts of the f32 MLP stage (the FMA products, the
  epilogue of the hidden layers, the head, the ring: its waits, barriers
  and copies, the weights then read from its first stage) at the
  :data:`MLP32_CELLS`: 1x4f at lane block 8 for CFR and FP and 2x3f for
  CFR at its chosen lane block, 256x2 net with LayerNorm, random weights
  from a seed; then, as a yardstick the port never calls, the MLP's
  products as ``torch.matmul`` in f32 (no TF32) at one iteration's rows
  of ``--batch`` lanes, per iteration and for 1024 iterations.
* ``body``: the phases of the iteration around the MLP (snapshots, reach
  grids, terminal values, level-1 values, root values with the running
  mean, the update) at the :data:`BODY_CELLS`: 1x4f at lane block 8
  without a net and with a bf16 net for CFR and FP, and 2x3f with a bf16
  net for CFR and FP at their chosen lane blocks.
* ``ring16``: the parts of the bf16 MLP where its hidden layers stream
  through the ring (the products, the epilogue, the ring's waits,
  departures and copies) at the :data:`RING16_CELLS`: a 256x3 net at
  1x4f at its chosen lane block, and the 256x2 net at 2x3f at lane block
  4, CFR and FP, each beside the resident layout at the lane block it
  fits (1x4f: none; 2x3f: 2).
* ``large``: the body's phases and the bf16 MLP's parts (products,
  epilogue, head, the ring's waits) at the :data:`LARGE_CELLS`, the games
  whose launches keep arrays in the device workspace: 2x5f and 3x3f CFR,
  2x6f and 3x4f CFR and FP at the lane block the wrapper chooses (1),
  and 3x3f and 2x6f CFR at lane block 2, with the fresh 256x2 nets of
  ``chip_smoke.py``'s ``large-games`` phase (:func:`large_net`).  Each variant builds only
  the instantiations these launches run (``build.build(units=)``), and
  each launch is warmed up by one of 4 iterations, then timed once a
  round.  Not in the default ``--parts`` (some 8 minutes a round).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import sys

import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.kernels import build
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

# The kernel's switches (its #define CUT_*): a variant takes out the parts
# of its mask.
CUTS = {"MMA_PRODUCTS": 1, "MMA_EPILOGUE": 2, "MMA_HEAD": 4,
        "RING16_WAIT": 8, "FMA_PRODUCTS": 16, "FMA_EPILOGUE": 32,
        "FMA_HEAD": 64, "FMA_RING": 128, "SNAPSHOTS": 256, "REACH": 512,
        "TERMINAL": 1024, "LEVEL1": 2048, "ROOT": 4096, "UPDATE": 8192}

# name: mask.  "no epilogue" also drops the rounding into the next A.
VARIANTS = {
    "whole": 0,
    "no products": CUTS["MMA_PRODUCTS"],
    "no epilogue": CUTS["MMA_EPILOGUE"],
    "no head": CUTS["MMA_HEAD"],
}
# name: (game (dice, faces), CFR); each at the lane block the wrapper
# chooses.
MLP_CELLS = {
    "1x4 cfr": ((1, 4), True),
    "1x4 fp": ((1, 4), False),
    "2x3 cfr": ((2, 3), True),
    "2x3 fp": ((2, 3), False),
    "1x6 fp": ((1, 6), False),
}

# The f32 MLP's parts.  "no ring": every slab is read from the first stage
# of the ring, with no wait, barrier or copy after the set-up's.
MLP32_VARIANTS = {
    "no products": CUTS["FMA_PRODUCTS"],
    "no epilogue": CUTS["FMA_EPILOGUE"],
    "no head": CUTS["FMA_HEAD"],
    "no ring": CUTS["FMA_RING"],
}
# name: (game (dice, faces), CFR, lane block; None: the chosen one)
MLP32_CELLS = {
    "1x4 cfr f32": ((1, 4), True, 8),
    "1x4 fp f32": ((1, 4), False, 8),
    "2x3 cfr f32": ((2, 3), True, None),
}

# The body's phases.  "no update": CFR's regret update and regret
# matching at both levels; FP's best-response sums and the average
# policy.
BODY_VARIANTS = {
    "no snapshots": CUTS["SNAPSHOTS"],
    "no reach": CUTS["REACH"],
    "no terminal values": CUTS["TERMINAL"],
    "no level-1 values": CUTS["LEVEL1"],
    "no root values": CUTS["ROOT"],
    "no update": CUTS["UPDATE"],
}
# name: (game (dice, faces), CFR, bf16 net, lane block; None: the chosen
# one)
BODY_CELLS = {
    "1x4 no net": ((1, 4), True, False, 8),
    "1x4 cfr bf16": ((1, 4), True, True, 8),
    "1x4 fp bf16": ((1, 4), False, True, 8),
    "2x3 cfr bf16": ((2, 3), True, True, None),
    "2x3 fp bf16": ((2, 3), False, True, None),
}

# The bf16 ring's parts.  "no ring waits": every slab is read from the
# first stage of the ring, with no wait, departure or copy after the
# set-up's.
RING16_VARIANTS = {
    "whole": 0,
    "no products": CUTS["MMA_PRODUCTS"],
    "no epilogue": CUTS["MMA_EPILOGUE"],
    "no ring waits": CUTS["RING16_WAIT"],
}
# name: (game (dice, faces), CFR, hidden layers, lane block; None: the
# chosen one)
RING16_CELLS = {
    "1x4 cfr 256x3": ((1, 4), True, 3, None),
    "2x3 cfr 256x2 ring": ((2, 3), True, 2, 4),
    "2x3 cfr 256x2 resident": ((2, 3), True, 2, 2),
    "2x3 fp 256x2 ring": ((2, 3), False, 2, 4),
    "2x3 fp 256x2 resident": ((2, 3), False, 2, 2),
}


# The large games' cells: name: (game (dice, faces), CFR, lane block;
# None: the chosen one), bf16 with a net.
LARGE_CELLS = {
    "2x5 cfr": ((2, 5), True, None),
    "3x3 cfr": ((3, 3), True, None),
    "3x3 cfr lb2": ((3, 3), True, 2),
    "2x6 cfr": ((2, 6), True, None),
    "2x6 cfr lb2": ((2, 6), True, 2),
    "2x6 fp": ((2, 6), False, None),
    "3x4 cfr": ((3, 4), True, None),
    "3x4 fp": ((3, 4), False, None),
}
LARGE_VARIANTS = {"whole": 0, **BODY_VARIANTS,
                  **{k: v for k, v in VARIANTS.items() if k != "whole"},
                  "no ring waits": CUTS["RING16_WAIT"]}
# The seeds of the large games' fresh nets (chip_smoke.py's large-games
# phase; chip_studies.py same-bits --large and plain-ms --large).
LARGE_NET_SEEDS = {(2, 5): 300, (3, 3): 301, (2, 6): 302, (3, 4): 340,
                   (1, 16): 341, (4, 3): 342, (2, 9): 343, (2, 10): 344}


def large_net(game: LiarsDice, seed: int | None = None, width: int = 256,
              layers: int = 2) -> CFVNet:
    """A fresh net of ``game``: CFVNet with LayerNorm from ``seed`` (by
    default the game's in :data:`LARGE_NET_SEEDS`), its LayerNorm scale
    drawn from [0.5, 1.5) and bias from [-0.5, 0.5), on the CPU."""
    if seed is None:
        seed = LARGE_NET_SEEDS[game.num_dice, game.num_faces]
    g = torch.Generator().manual_seed(seed)
    net = CFVNet(game, width, layers, True, generator=g)
    with torch.no_grad():
        for _, ln in net.hidden_layers():
            ln.weight.copy_(0.5 + torch.rand(width, generator=g))
            ln.bias.copy_(torch.rand(width, generator=g) - 0.5)
    return net


def build_variants(variants: dict, units=None) -> dict:
    """``{name: library}`` for ``{name: mask}``: the kernel with the parts
    of each mask taken out, compiled side by side (one ``nvcc`` each);
    ``units``: only those instantiations (``build.build``)."""
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(
            lambda mask: build.build(
                "grid2_cfr", (f"BREAKDOWN={mask}",) if mask else (), units),
            variants.values()))
    return {name: ctypes.CDLL(str(path))
            for name, path in zip(variants, paths)}


@contextlib.contextmanager
def using(lib):
    """``grid2p.solve`` launches from ``lib`` inside the block."""
    before = build._loaded.get("grid2_cfr")
    build._loaded["grid2_cfr"] = lib
    try:
        yield
    finally:
        if before is None:
            build._loaded.pop("grid2_cfr", None)
        else:
            build._loaded["grid2_cfr"] = before


def time_launch(args, reps: int = 3, warm: bool = True, **knobs) -> float:
    """ms per launch of ``grid2p.solve(*args, **knobs)``, after a warm-up
    launch (``warm``; else the caller's)."""
    if warm:
        grid2p.solve(*args, **knobs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        grid2p.solve(*args, **knobs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_states(game: LiarsDice, batch: int, dev) -> list:
    """Roots, players, Dirichlet(1) beliefs and stop iterations of
    ``batch`` lanes, from a seed."""
    A, H = game.num_actions, game.num_hands
    g = torch.Generator().manual_seed(3)
    expo = -torch.log(torch.rand((batch, 2, H), generator=g))
    return [torch.randint(-1, A - 1, (batch,), generator=g).to(dev),
            torch.randint(0, 2, (batch,), generator=g).to(dev),
            (expo / expo.sum(-1, keepdim=True)).to(dev),
            torch.randint(0, 1025, (batch,), generator=g).to(dev)]


def solve_args(game, states, use_cfr, net, dtype=torch.bfloat16):
    return (game, SubgameSolvingParams(num_iters=1024, max_depth=2,
                                       use_cfr=use_cfr, linear_update=True),
            *states, net, dtype)


def mlp_part(rounds: int, batch: int, dev) -> None:
    game = LiarsDice(1, 4)
    states = random_states(game, batch, dev)
    nets = {ln: CFVNet(game, 256, 2, ln,
                       generator=torch.Generator().manual_seed(5)).to(dev)
            for ln in (True, False)}
    cells = {}
    for cell, ((nd, nf), use_cfr) in MLP_CELLS.items():
        g_ = LiarsDice(nd, nf)
        net = CFVNet(g_, 256, 2, True,
                     generator=torch.Generator().manual_seed(5)).to(dev)
        args = solve_args(g_, random_states(g_, batch, dev), use_cfr, net)
        cells[cell] = (args, grid2p.choose_lane_block(
            *args[:2], net, torch.bfloat16, batch))
    libs = build_variants(VARIANTS)
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, lane_block) in cells.items():
                    ms = time_launch(args, reps=2, lane_block=lane_block)
                    print(json.dumps({"round": rnd, "variant": name,
                                      "cell": cell, "lane_block": lane_block,
                                      "ms": ms}), flush=True)
        with using(libs["whole"]):
            for label, net, knobs in (
                    ("nogelu", nets[True], dict(ablate="nogelu")),
                    ("noln", nets[True], dict(ablate="noln")),
                    ("net without LayerNorm, nogelu", nets[False],
                     dict(ablate="nogelu")),
                    ("no net", None, {}),
                    ("interleave=2", nets[True], dict(interleave=2))):
                ms = time_launch(solve_args(game, states, True, net),
                                 **knobs)
                print(json.dumps({"round": rnd, "variant": "whole",
                                  "solver": "cfr", "knobs": label,
                                  "ms": ms}), flush=True)


def mlp32_part(rounds: int, batch: int, dev) -> None:
    libs = build_variants({"whole": 0, **MLP32_VARIANTS})
    cells = {}
    for cell, ((nd, nf), use_cfr, lane_block) in MLP32_CELLS.items():
        game = LiarsDice(nd, nf)
        net = CFVNet(game, 256, 2, True,
                     generator=torch.Generator().manual_seed(5)).to(dev)
        args = solve_args(game, random_states(game, batch, dev), use_cfr,
                          net, torch.float32)
        if lane_block is None:
            lane_block = grid2p.choose_lane_block(*args[:2], net,
                                                  torch.float32, batch)
        cells[cell] = (args, lane_block)
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, lane_block) in cells.items():
                    ms = time_launch(args, reps=2, lane_block=lane_block)
                    print(json.dumps({"round": rnd, "part": "mlp32",
                                      "variant": name, "cell": cell,
                                      "lane_block": lane_block, "ms": ms}),
                          flush=True)
    # The yardstick: the MLP's products at one iteration's rows.
    torch.backends.cuda.matmul.allow_tf32 = False
    for cell, (args, _) in cells.items():
        game, net = args[0], args[6]
        rows = len(grid2p.pseudo_leaf_pairs(game)) * batch
        g = torch.Generator(dev).manual_seed(7)
        mats = [(torch.rand((rows, k), device=dev, generator=g),
                 lin.weight.detach().T.contiguous())
                for k, lin in zip([game.query_size] + [net.n_hidden]
                                  * net.n_layers,
                                  [lin for lin, _ in net.hidden_layers()]
                                  + [net.output])]
        for x, w in mats:
            torch.matmul(x, w)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 20
        start.record()
        for _ in range(reps):
            for x, w in mats:
                torch.matmul(x, w)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        print(json.dumps({"part": "mlp32", "yardstick": "torch.matmul f32",
                          "cell": cell, "rows": rows,
                          "shapes": [[*x.shape, w.shape[1]] for x, w in mats],
                          "ms_per_iteration": ms,
                          "ms_1024_iterations": ms * 1024}), flush=True)


def body_part(rounds: int, batch: int, dev) -> None:
    libs = build_variants({"whole": 0, **BODY_VARIANTS})
    cells = {}
    for cell, ((nd, nf), use_cfr, has_net, lane_block) in BODY_CELLS.items():
        game = LiarsDice(nd, nf)
        net = (CFVNet(game, 256, 2, True,
                      generator=torch.Generator().manual_seed(5)).to(dev)
               if has_net else None)
        args = solve_args(game, random_states(game, batch, dev), use_cfr,
                          net)
        if lane_block is None:
            lane_block = grid2p.choose_lane_block(*args[:2], net,
                                                  torch.bfloat16, batch)
        cells[cell] = (args, lane_block)
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, lane_block) in cells.items():
                    ms = time_launch(args, reps=2, lane_block=lane_block)
                    print(json.dumps({"round": rnd, "part": "body",
                                      "variant": name, "cell": cell,
                                      "lane_block": lane_block, "ms": ms}),
                          flush=True)


def ring16_part(rounds: int, batch: int, dev) -> None:
    libs = build_variants(RING16_VARIANTS)
    cells = {}
    for cell, ((nd, nf), use_cfr, layers, lane_block) in RING16_CELLS.items():
        game = LiarsDice(nd, nf)
        net = CFVNet(game, 256, layers, True,
                     generator=torch.Generator().manual_seed(5)).to(dev)
        args = solve_args(game, random_states(game, batch, dev), use_cfr,
                          net)
        if lane_block is None:
            lane_block = grid2p.choose_lane_block(*args[:2], net,
                                                  torch.bfloat16, batch)
        ring = grid2p.kernel_plan(*args[:2], net, torch.bfloat16, batch,
                                  lane_block).ring
        cells[cell] = (args, lane_block, ring)
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, lane_block, ring) in cells.items():
                    ms = time_launch(args, reps=2, lane_block=lane_block)
                    print(json.dumps({"round": rnd, "part": "ring16",
                                      "variant": name, "cell": cell,
                                      "lane_block": lane_block,
                                      "ring": ring, "ms": ms}), flush=True)


def large_part(rounds: int, batch: int, dev) -> None:
    cells, units = {}, set()
    for cell, ((nd, nf), use_cfr, lane_block) in LARGE_CELLS.items():
        game = LiarsDice(nd, nf)
        net = large_net(game).to(dev)
        args = solve_args(game, random_states(game, batch, dev), use_cfr,
                          net)
        if lane_block is None:
            lane_block = grid2p.choose_lane_block(*args[:2], net,
                                                  torch.bfloat16, batch)
        plan = grid2p.kernel_plan(*args[:2], net, torch.bfloat16, batch,
                                  lane_block)
        units.add(grid2p.kernel_unit(args[1], plan, True))
        warm = (game, args[1].replace(num_iters=4), *args[2:5],
                torch.clamp(args[5], max=4), *args[6:])
        cells[cell] = (args, warm, lane_block, plan.layout)
    libs = build_variants(LARGE_VARIANTS, tuple(sorted(units)))
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, warm, lane_block, layout) in cells.items():
                    grid2p.solve(*warm, lane_block=lane_block)
                    ms = time_launch(args, reps=1, warm=False,
                                     lane_block=lane_block)
                    print(json.dumps({"round": rnd, "part": "large",
                                      "variant": name, "cell": cell,
                                      "lane_block": lane_block,
                                      "layout": layout, "ms": ms}),
                          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--parts", default="mlp,mlp32,body,ring16")
    args = ap.parse_args(argv)
    parts = [x for x in args.parts.split(",") if x]
    if any(x not in PARTS for x in parts):
        ap.error(f"--parts takes {', '.join(PARTS)}, not {args.parts}")
    if not torch.cuda.is_available():
        print("mlp_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from rebel_tpu_torch.bench import card_name_and_power_limit

    print(json.dumps({"card": card_name_and_power_limit()}), flush=True)
    dev = torch.device("cuda")
    for part in parts:
        PARTS[part](args.rounds, args.batch, dev)
    return 0


PARTS = {"mlp": mlp_part, "mlp32": mlp32_part, "body": body_part,
         "ring16": ring16_part, "large": large_part}


if __name__ == "__main__":
    sys.exit(main())
