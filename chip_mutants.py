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
mutant is *caught* if any check says MISS or the card stops the kernel
with a fault (:data:`KERNEL_FAULTS`); a run that fails without either (a
mutant that does not build, a Python error of the harness) is *harness
failed*, and the script then exits 1.  The checkout itself is never
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
CHECK_PHASES = "cfr-checks,fp-checks"
# What the CUDA runtime prints when the card stops a faulty kernel.
KERNEL_FAULTS = ("illegal memory access", "illegal instruction",
                 "misaligned address", "unspecified launch failure",
                 "device-side assert")

# name: (line of the kernel, its replacement, phases that should catch it)
MUTANTS = {
    "none": (None, None, FP_PHASES),
    # FP: ties broken to the highest action at level 1 and at the root.
    "fp-ties-highest": (
        "if (m0a && q > vmax) { vmax = q; best = a2; }",
        "if (m0a && q >= vmax) { vmax = q; best = a2; }",
        FP_PHASES),
    "fp-root-ties-highest": (
        "if (mb > 0.f && vb > st) { st = vb; best = b; }",
        "if (mb > 0.f && vb >= st) { st = vb; best = b; }",
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
    # The second moves rvm only, never the policy: it is also run through
    # the no-net check over 1024 iterations (cfr-checks).
    "cfr-discount-256": (
        "pos_d = neg_d = ns / (ns + 1.0f);",
        "pos_d = neg_d = it >= 256 ? (ns + 1.0f) / (ns + 2.0f) "
        ": ns / (ns + 1.0f);",
        CFR_PHASES),
    "cfr-alpha-256": (
        "alpha = p.linear ? 2.0f / (n_it + 2.0f) : 1.0f / (n_it + 1.0f);",
        "alpha = p.linear ? 2.0f / (n_it + (it >= 256 ? 3.0f : 2.0f)) "
        ": 1.0f / (n_it + 1.0f);",
        "cfr-checks," + CFR_PHASES),
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
    # The iteration body.  The work split: the lane multiplier one short,
    # so that the first lane of every reach item but the first is dealt as
    # lane LB of the item before, one past the group's lanes.  A dropped
    # group barrier: the root values read level-1 values that other
    # threads may not have written yet.  One lane's snapshot an iteration
    # late: the second lane of every group stops one iteration after its
    # t_stop.
    "split-lane-edge": (
        "p.mul_LB = (uint32_t)ints[23];",
        "p.mul_LB = (uint32_t)ints[23] - 1u;",
        CHECK_PHASES),
    "barrier-dropped": (
        "            V1[(l * A + a1) * H + h] = v;\n        }\n        gsync();",
        "            V1[(l * A + a1) * H + h] = v;\n        }",
        CHECK_PHASES),
    "snapshot-late": (
        "s_tstop[l] = p.t_stop[lane0 + l];",
        "s_tstop[l] = p.t_stop[lane0 + l] + (l == 1);",
        CHECK_PHASES),
    # The tensor-core MLP (bf16): the hidden layers' B operand read one
    # 8-column group on (output column n takes weight column n + 8), the
    # head's B fragment with its two k halves swapped, and LayerNorm's row
    # statistics reduced over the wrong threads' partial sums (lanes 2 and
    # 4 apart: half of them hold another row).  The f32 kernels do not run
    # this code.
    "mma-b-shift": (
        "mma_desc(w + 256 * s, 128, sbo)",
        "mma_desc(w + 256 * s + sbo, 128, sbo)",
        KNOB_PHASES),
    "mma-head-fragment": (
        "a[4 * s + 3], b[64 * s], b[64 * s + 32]);",
        "a[4 * s + 3], b[64 * s + 32], b[64 * s]);",
        KNOB_PHASES),
    "mma-ln-stats": (
        "for (int off = 1; off < 4; off <<= 1) {",
        "for (int off = 2; off < 8; off <<= 1) {",
        KNOB_PHASES),
    # The f32 MLP: every warp reads a ring stage without waiting on its
    # full barrier (before the slab's copy may have landed), and the
    # epilogue's column map shifted by one (column j takes the bias of
    # column j + 1; the checks' nets keep LayerNorm's scale 1 and bias 0,
    # so a shift of those columns alone changes nothing there).  The bf16
    # kernels do not run this code.
    "ring-no-wait": (
        "    mbar_wait(g.full + s, parity);\n    f(g.stages",
        "    f(g.stages",
        CHECK_PHASES),
    "epilogue-column-shift": (
        "        const float b = __ldg(bias + lane + 32 * i);",
        "        const float b = __ldg(bias + (lane + 1 + 32 * i) % NH);",
        CHECK_PHASES),
    # The same shift in LayerNorm's scale (the checks' nets draw it from a
    # seed).
    "epilogue-ln-scale-shift": (
        "            const float g = __ldg(scale + j), b = __ldg(lbias + j);",
        "            const float g = __ldg(scale + (j + 1) % NH), "
        "b = __ldg(lbias + j);",
        CHECK_PHASES),
}


def run(name: str) -> str:
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
    verdict, lines = judge(proc.returncode,
                           (proc.stdout + proc.stderr).splitlines())
    print(f"=== mutant {name} (phases {phases}): exit {proc.returncode}, "
          f"{verdict}")
    for ln in lines:
        print(f"    {ln}")
    sys.stdout.flush()
    return verdict


def judge(returncode: int, output: list[str]) -> tuple[str, list[str]]:
    """The verdict on one mutant's run of ``chip_smoke.py`` and the lines
    of its output that show it: every check line and error, or the last
    40 lines where the harness failed."""
    lines = [ln for ln in output
             if ln.startswith(("check ", "control ", "chip_smoke:"))
             or "walked episodes" in ln or "Error" in ln]
    if any("MISS" in ln for ln in lines if not ln.startswith("control ")) \
            or any(f in ln for ln in output for f in KERNEL_FAULTS):
        return "CAUGHT", lines
    if returncode != 0:
        return "harness failed", output[-40:]
    return "not caught", lines


def main() -> int:
    names = sys.argv[1:] or list(MUTANTS)
    unknown = [n for n in names if n not in MUTANTS]
    if unknown:
        raise SystemExit(f"unknown mutants {unknown}; known: "
                         f"{list(MUTANTS)}")
    verdicts = {name: run(name) for name in names}
    print(f"mutants: {verdicts}")
    return int("harness failed" in verdicts.values())


if __name__ == "__main__":
    sys.exit(main())
