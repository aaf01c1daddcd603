"""Where a launch of the fused solve spends its time, on the card.

    python -m rebel_tpu_torch.mlp_breakdown [--rounds 2] [--batch 1024]

Builds variants of ``kernels/grid2_cfr.cu`` with one part of the bf16 MLP
stage taken out (the wgmma products, the f32 epilogue of the hidden
layers, the head) beside the source as it is, and times one launch of
each at 1x4f (256x2 net with LayerNorm, random weights from a seed,
``--batch`` lanes, 1024 iterations, lane block 8) for CFR and fictitious
play, in rounds (every variant once per round), with CUDA events; then
the whole kernel with the ablations and without a net.  A variant's
results are wrong by construction: only its time means something.  Prints
one JSON line per reading.
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

# name: (a line of the kernel, its replacement)
VARIANTS = {
    "whole": None,
    "no products": ("    for (int s = 0; s < S; ++s)\n        wgmma_m64n256k16(",
                    "    for (int s = 0; s < 0; ++s)\n        wgmma_m64n256k16("),
    "no epilogue": ("        const float* bias = f32 + 3 * k * NH;",
                    "        continue;\n        const float* bias = f32 + 3 * k * NH;"),
    "no head": ("for (int nt = 0; nt < mlp_hn(p.H) / 8; ++nt) {",
                "for (int nt = 0; nt < 0; ++nt) {"),
}


def build_variants() -> dict:
    """``{name: library}``, compiled side by side into the build directory."""
    src = (build.KERNEL_DIR / "grid2_cfr.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edit in VARIANTS.items():
        text = src
        if edit is not None:
            if src.count(edit[0]) != 1:
                raise SystemExit(f"variant {name!r}: its line occurs "
                                 f"{src.count(edit[0])} times")
            text = src.replace(*edit)
        tag = name.replace(" ", "_")
        cu = build.BUILD_DIR / f"breakdown_{tag}.cu"
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from rebel_tpu_torch.bench import card_name_and_power_limit

    print(json.dumps({"card": card_name_and_power_limit()}), flush=True)
    dev = torch.device("cuda")
    game = LiarsDice(1, 4)
    A, H, B = game.num_actions, game.num_hands, args.batch
    g = torch.Generator().manual_seed(3)
    expo = -torch.log(torch.rand((B, 2, H), generator=g))
    states = [torch.randint(-1, A - 1, (B,), generator=g).to(dev),
              torch.randint(0, 2, (B,), generator=g).to(dev),
              (expo / expo.sum(-1, keepdim=True)).to(dev),
              torch.randint(0, 1025, (B,), generator=g).to(dev)]
    nets = {ln: CFVNet(game, 256, 2, ln,
                       generator=torch.Generator().manual_seed(5)).to(dev)
            for ln in (True, False)}

    def solve_args(use_cfr, net):
        return (game, SubgameSolvingParams(num_iters=1024, max_depth=2,
                                           use_cfr=use_cfr,
                                           linear_update=True),
                *states, net, torch.bfloat16)

    libs = build_variants()
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            with using(lib):
                for use_cfr in (True, False):
                    ms = time_launch(solve_args(use_cfr, nets[True]))
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
                ms = time_launch(solve_args(True, net), **knobs)
                print(json.dumps({"round": rnd, "variant": "whole",
                                  "solver": "cfr", "knobs": label,
                                  "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
