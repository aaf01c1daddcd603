"""Where a launch of the fused solve spends its time, on the card.

    python -m rebel_tpu_torch.mlp_breakdown [--rounds 2] [--batch 1024]
        [--parts mlp,body]

Builds variants of ``kernels/grid2_cfr.cu`` with one part taken out beside
the source as it is, and times one launch of each with CUDA events, in
rounds (every variant once per round).  A variant's results are wrong by construction: only its
time means something.  Prints one JSON line per reading.

* ``mlp``: the parts of the bf16 MLP stage (the wgmma products, the f32
  epilogue of the hidden layers, the head), at 1x4f (256x2 net with
  LayerNorm, random weights from a seed, ``--batch`` lanes, 1024
  iterations, lane block 8) for CFR and fictitious play; then the whole
  kernel with the ablations and without a net.
* ``body``: the phases of the iteration around the MLP (snapshots, reach
  grids, terminal values, level-1 values, root values with the running
  mean, the update) at the :data:`BODY_CELLS`: 1x4f at lane block 8
  without a net and with a bf16 net for CFR and FP, and 2x3f with a bf16
  net for CFR (lane block 2) and FP (lane block 1).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys

import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.kernels import build
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

# name: [(a line of the kernel, its replacement), ...]; every edit of a
# variant must apply.
VARIANTS = {
    "whole": None,
    "no products": [("    for (int s = 0; s < S; ++s)\n        wgmma_m64n256k16(",
                     "    for (int s = 0; s < 0; ++s)\n        wgmma_m64n256k16(")],
    "no epilogue": [("        const float* bias = f32 + 3 * k * NH;",
                     "        continue;\n        const float* bias = f32 + 3 * k * NH;")],
    "no head": [("for (int nt = 0; nt < mlp_hn(p.H) / 8; ++nt) {",
                 "for (int nt = 0; nt < 0; ++nt) {")],
}

# The body's phases.
# "no update": CFR's regret update and regret matching at both levels;
# FP's best-response sums and the average policy.
BODY_VARIANTS = {
    "no snapshots": [("if (it == next_stop) {", "if (false) {")],
    "no reach": [("const int n_reach = LB * K_REACH;",
                  "const int n_reach = 0;")],
    "no terminal values": [("i < (A + 1) * LB * H; i += GT) {",
                            "i < 0; i += GT) {")],
    "no level-1 values": [("i < A * LB * H; i += GT) {",
                           "i < 0; i += GT) {")],
    "no root values": [("const int n = LB * H;  // root rows",
                        "const int n = 0;")],
    "no update": [("if (lvl1_is_trav) {\n                    const float bt",
                   "if (false) {\n                    const float bt"),
                  ("if (lvl1_is_trav) {\n                    float* r",
                   "if (false) {\n                    float* r"),
                  ("const bool store = live && root_is_trav;",
                   "const bool store = false;")],
}
# name: (game (dice, faces), CFR, bf16 net, lane block)
BODY_CELLS = {
    "1x4 no net": ((1, 4), True, False, 8),
    "1x4 cfr bf16": ((1, 4), True, True, 8),
    "1x4 fp bf16": ((1, 4), False, True, 8),
    "2x3 cfr bf16": ((2, 3), True, True, 2),
    "2x3 fp bf16": ((2, 3), False, True, 1),
}


def build_variants(src: str, variants: dict, tag: str) -> dict:
    """``{name: library}`` for ``{name: [(old, new), ...] or None}``,
    compiled side by side into the build directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits or ():
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its line occurs "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        cu = build.BUILD_DIR / f"breakdown_{tag}_{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


class OtherLayout:
    """A library built from another version of ``grid2_cfr.cu``, whose
    shared-memory layout may differ from the tree's.  ``grid2p.solve``
    holds the tree's reckoning (``smem_layout``) to the library's own and
    refuses a launch where they differ; this one answers with the tree's
    library and launches with its own layout (a layout that does not fit
    makes the launch fail, which ``solve`` raises)."""

    def __init__(self, lib, tree):
        self._lib, self.grid2_cfr_smem_bytes = lib, tree.grid2_cfr_smem_bytes

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def using(lib, other_layout: bool = False):
    """``grid2p.solve`` launches from ``lib`` inside the block;
    ``other_layout``: ``lib`` is another version (:class:`OtherLayout`)."""
    if other_layout:
        tree = build.load("grid2_cfr")
        grid2p._declare(tree)
        lib = OtherLayout(lib, tree)
    before = build._loaded.get("grid2_cfr")
    build._loaded["grid2_cfr"] = lib
    try:
        yield
    finally:
        if before is None:
            build._loaded.pop("grid2_cfr", None)
        else:
            build._loaded["grid2_cfr"] = before


def time_launch(args, reps: int = 3, **knobs) -> float:
    """ms per launch of ``grid2p.solve(*args, **knobs)``, after a warm-up."""
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


def solve_args(game, states, use_cfr, net):
    return (game, SubgameSolvingParams(num_iters=1024, max_depth=2,
                                       use_cfr=use_cfr, linear_update=True),
            *states, net, torch.bfloat16)


def mlp_part(src: str, rounds: int, batch: int, dev) -> None:
    game = LiarsDice(1, 4)
    states = random_states(game, batch, dev)
    nets = {ln: CFVNet(game, 256, 2, ln,
                       generator=torch.Generator().manual_seed(5)).to(dev)
            for ln in (True, False)}
    libs = build_variants(src, VARIANTS, "mlp")
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for use_cfr in (True, False):
                    ms = time_launch(solve_args(game, states, use_cfr,
                                                nets[True]))
                    print(json.dumps({"round": rnd, "variant": name,
                                      "solver": "cfr" if use_cfr else "fp",
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


def body_part(src: str, rounds: int, batch: int, dev) -> None:
    variants = {"whole": None, **BODY_VARIANTS}
    libs = build_variants(src, variants, "body")
    cells = {}
    for cell, ((nd, nf), use_cfr, has_net, lane_block) in BODY_CELLS.items():
        game = LiarsDice(nd, nf)
        net = (CFVNet(game, 256, 2, True,
                      generator=torch.Generator().manual_seed(5)).to(dev)
               if has_net else None)
        cells[cell] = (solve_args(game, random_states(game, batch, dev),
                                  use_cfr, net), lane_block)
    for rnd in range(rounds):
        for name, lib in libs.items():
            with using(lib):
                for cell, (args, lane_block) in cells.items():
                    ms = time_launch(args, reps=2, lane_block=lane_block)
                    print(json.dumps({"round": rnd, "part": "body",
                                      "variant": name, "cell": cell,
                                      "lane_block": lane_block, "ms": ms}),
                          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--parts", default="mlp,body")
    args = ap.parse_args(argv)
    parts = [x for x in args.parts.split(",") if x]
    if any(x not in ("mlp", "body") for x in parts):
        ap.error(f"--parts takes mlp and body, not {args.parts}")
    if not torch.cuda.is_available():
        print("mlp_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from rebel_tpu_torch.bench import card_name_and_power_limit

    src = (build.KERNEL_DIR / "grid2_cfr.cu").read_text()
    print(json.dumps({"card": card_name_and_power_limit()}), flush=True)
    dev = torch.device("cuda")
    if "mlp" in parts:
        mlp_part(src, args.rounds, args.batch, dev)
    if "body" in parts:
        body_part(src, args.rounds, args.batch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
