#!/usr/bin/env python3
"""Mutants of the fused solve, to show that ``chip_smoke.py``'s limits
separate a wrong kernel from a right one.

    python3 chip_mutants.py [name ...]

From the root of a checkout, on a machine with an NVIDIA GPU.  For each
mutant (all, or the named ones) it copies the port and ``chip_smoke.py``
into a temporary directory, changes one line of
``rebel_tpu_torch/kernels/grid2_cfr.cu`` there, runs the phases of
``chip_smoke.py`` that should catch it, and prints every check line with
its verdict.  ``none`` runs the same phases on the unchanged kernel.  A
mutant is *caught* if any check says MISS.  The checkout itself is never
changed.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL = "rebel_tpu_torch/kernels/grid2_cfr.cu"
FP_PHASES = "fp-checks,exploit-check,fp-selfplay"
CFR_PHASES = "exploit-check"
KNOB_PHASES = "knob-checks"

# name: (line of the kernel, its replacement, phases that should catch it)
MUTANTS = {
    "none": (None, None, FP_PHASES),
    # FP: ties broken to the highest action at level 1 and at the root.
    "fp-ties-highest": (
        "if (m0a && a2 > a1 && q > vmax) { vmax = q; best = a2; }",
        "if (m0a && a2 > a1 && q >= vmax) { vmax = q; best = a2; }",
        FP_PHASES),
    "fp-root-ties-highest": (
        "if (m > 0.f && v1 > st) { st = v1; best = a; }",
        "if (m > 0.f && v1 >= st) { st = v1; best = a; }",
        FP_PHASES),
    # FP: the sums' decay off by one, from iteration 16 and from 256.
    "fp-decay-16": (
        "if (p.linear) fp_decay = (nu + 1.0f) / (nu + 2.0f);",
        "if (p.linear) fp_decay = it >= 16 ? (nu + 2.0f) / (nu + 3.0f) "
        ": (nu + 1.0f) / (nu + 2.0f);",
        FP_PHASES),
    "fp-decay-256": (
        "if (p.linear) fp_decay = (nu + 1.0f) / (nu + 2.0f);",
        "if (p.linear) fp_decay = it >= 256 ? (nu + 2.0f) / (nu + 3.0f) "
        ": (nu + 1.0f) / (nu + 2.0f);",
        FP_PHASES),
    # FP: the running mean's weight off by one from iteration 256.
    "fp-alpha-256": (
        "alpha = p.linear ? 2.0f / (nu + 1.0f) : 1.0f / nu;",
        "alpha = p.linear ? 2.0f / (nu + (it >= 256 ? 2.0f : 1.0f)) "
        ": 1.0f / nu;",
        FP_PHASES),
    # CFR: the discount, and the running mean's weight, off by one from
    # iteration 256: the mutants no comparison of iterates could catch.
    "cfr-discount-256": (
        "pos_d = neg_d = ns / (ns + 1.0f);",
        "pos_d = neg_d = it >= 256 ? (ns + 1.0f) / (ns + 2.0f) "
        ": ns / (ns + 1.0f);",
        CFR_PHASES),
    "cfr-alpha-256": (
        "alpha = p.linear ? 2.0f / (n_it + 2.0f) : 1.0f / (n_it + 1.0f);",
        "alpha = p.linear ? 2.0f / (n_it + (it >= 256 ? 3.0f : 2.0f)) "
        ": 1.0f / (n_it + 1.0f);",
        CFR_PHASES),
    # CFR: the discount off by one from iteration 16 (caught since the
    # first slice by the 64-iteration statistics; here by exploitability).
    "cfr-discount-16": (
        "pos_d = neg_d = ns / (ns + 1.0f);",
        "pos_d = neg_d = it >= 16 ? (ns + 1.0f) / (ns + 2.0f) "
        ": ns / (ns + 1.0f);",
        CFR_PHASES),
    # The two-group CFR kernel: the second group of warps reads the first
    # group's stop iterations (the one-group kernels are unchanged by it).
    "il2-tstop": (
        "s_tstop[l] = p.t_stop[lane0 + l];",
        "s_tstop[l] = p.t_stop[blockIdx.x * p.LB + l];",
        KNOB_PHASES),
}


def run(name: str) -> bool:
    old, new, phases = MUTANTS[name]
    with tempfile.TemporaryDirectory(prefix=f"mutant-{name}-") as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copytree(
            ROOT / "rebel_tpu_torch", tmp / "rebel_tpu_torch",
            ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp / "chip_smoke.py")
        for ckpt in ("r4_1x4cfr/ckpt/epoch990.params",
                     "r5_1x4fp/ckpt/epoch800.params"):
            dst = tmp / "results" / "liars_sp" / ckpt
            dst.parent.mkdir(parents=True)
            shutil.copy(ROOT / "results" / "liars_sp" / ckpt, dst)
        if old is not None:
            src = (tmp / KERNEL).read_text()
            if src.count(old) != 1:
                raise SystemExit(f"mutant {name}: its line occurs "
                                 f"{src.count(old)} times in {KERNEL}")
            (tmp / KERNEL).write_text(src.replace(old, new))
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases", phases],
            cwd=tmp, capture_output=True, text=True)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if ln.startswith(("check ", "control ", "chip_smoke:"))
             or "walked episodes" in ln or "Error" in ln]
    caught = any("MISS" in ln for ln in lines)
    print(f"=== mutant {name} (phases {phases}): exit {proc.returncode}, "
          f"{'CAUGHT' if caught else 'not caught'}")
    for ln in lines:
        print(f"    {ln}")
    sys.stdout.flush()
    return caught


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    unknown = [n for n in names if n not in MUTANTS]
    if unknown:
        raise SystemExit(f"unknown mutants {unknown}; known: "
                         f"{list(MUTANTS)}")
    verdicts = {name: run(name) for name in names}
    print(f"mutants caught: {verdicts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
