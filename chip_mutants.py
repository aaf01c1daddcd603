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
WIDTH_PHASES = "widths"
LARGE_PHASES = "large-games"
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
        "        gsync();\n\n        // ---- 4. root values",
        "\n        // ---- 4. root values",
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
        "    mbar_wait(g.full + s, parity);\n    f(reinterpret_cast",
        "    f(reinterpret_cast",
        CHECK_PHASES),
    "epilogue-column-shift": (
        "        const float b = __ldg(bias + lane + 32 * i);",
        "        const float b = __ldg(bias + (lane + 1 + 32 * i) % NH);",
        CHECK_PHASES),
    # The bf16 MLP's rows: a warp whose only real row is its first taken
    # for padding (it skips the epilogue and the head; knob-checks'
    # mlp_chunks=28 at lane block 1 gives a warp one real row).
    "pad-skip-real": (
        "const bool warp_live = R0 < n;",
        "const bool warp_live = R0 + 1 < n;",
        KNOB_PHASES),
    # The same shift in LayerNorm's scale (the checks' nets draw it from a
    # seed).
    "epilogue-ln-scale-shift": (
        "            const float g = __ldg(scale + j), b = __ldg(lbias + j);",
        "            const float g = __ldg(scale + (j + 1) % NH), "
        "b = __ldg(lbias + j);",
        CHECK_PHASES),
    # The bf16 ring: every warp reads a stage without waiting on its full
    # barrier (before the slab's copy may have landed); the widths phase's
    # bf16 nets of 3 hidden layers and more stream through it.
    "ring16-no-wait": (
        "    mbar_wait(g.full + s, parity);\n    __syncwarp();\n"
        "    f(smem_addr",
        "    __syncwarp();\n    f(smem_addr",
        WIDTH_PHASES),
    # The bf16 MLP's LayerNorm divides its sums by the padded width, not
    # the net's own (the same at width 256; the widths phase's narrower
    # nets with LayerNorm show it).
    "ln-pad-width": (
        "const float inv_n = p.inv_nh;  // 1 / the net's own width",
        "const float inv_n = 1.0f / NH;  // 1 / the net's own width",
        WIDTH_PHASES),
    # Rows wider than a warp: the reach phase's sums over an item's hands
    # leave out every lane's second value (hands 32 and on; 2x6f has 36).
    # The workspace: its launches read the reach phase's staging rows and
    # reaches without the group's barrier after that phase (the
    # shared-memory launches keep it).
    "wide-row-second-value": (
        "for (int h = 0; h < H; ++h) sum += rw[h];",
        "for (int h = 0; h < min(H, 32); ++h) sum += rw[h];",
        LARGE_PHASES),
    # Rows of 65-128 hands (four values a lane): the reach phase's sums
    # over an item's hands leave out hands 96 and on (2x10f has 100).
    "reach-drop-96": (
        "for (int h = 0; h < H; ++h) sum += rw[h];",
        "for (int h = 0; h < min(H, 96); ++h) sum += rw[h];",
        LARGE_PHASES),
    "workspace-barrier-dropped": (
        "        gsync();\n\n        // ---- 2. terminal values",
        "        if constexpr (!WS) gsync();\n\n"
        "        // ---- 2. terminal values",
        LARGE_PHASES),
    # The workspace's new steps: each summing lane of the reach phase reads
    # its neighbour's row in shared memory (x0's sum from x1's row and so
    # on); the terminal values compute the payoff from the matches of the
    # next face, or read the reach values of the next challenge row; the
    # level-1 arrays' cells sit one cell off (each lane's last cell on the
    # next lane's first).
    "reach-rows-shift": (
        "const float* rw = rows + wl * HP;",
        "const float* rw = rows + (wl ^ 1) * HP;",
        LARGE_PHASES),
    "terminal-payoff-face": (
        "const float pv = own_h + matches[o * F + face]",
        "const float pv = own_h + matches[o * F + (face + 1) % F]",
        LARGE_PHASES),
    "terminal-reach-row": (
        "const float* r2 = w.r2liar + (l * A + a1) * H;",
        "const float* r2 = w.r2liar + (l * A + (a1 + 1) % A) * H;",
        LARGE_PHASES),
    "level1-cell-shift": (
        "a1 * (a1 + 1) / 2 - 1)",
        "a1 * (a1 + 1) / 2 + 0)",
        LARGE_PHASES),
    # The wide bf16 MLP (nets of 257-512 at the padded width 512, both
    # warpgroups on one tile, each half the columns): LayerNorm takes a
    # row's statistics from its own warpgroup's half of the columns only
    # (twice that half's sums); the pair's barrier after the layer's
    # products is dropped, so that a warpgroup may overwrite A (and read
    # the other half's LayerNorm sums) before the other has read it.  The
    # widths phase's nets of 300, 384 and 512 run it.
    "wide-ln-half": (
        "const float *half0 = stats, *half1 = stats + 2 * MMA_ROWS;",
        "const float *half0 = stats + 2 * MMA_ROWS * g, *half1 = half0;",
        WIDTH_PHASES),
    "wide-a-overwrite": (
        "        pair_sync();  // A free: the layer's products have read it "
        "all\n",
        "",
        WIDTH_PHASES),
}


def run(name: str) -> str:
    old, new, phases = MUTANTS[name]
    with tempfile.TemporaryDirectory(prefix=f"mutant-{name}-") as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copytree(
            ROOT / "rebel_tpu_torch", tmp / "rebel_tpu_torch",
            ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for script in ("chip_smoke.py", "chip_studies.py"):
            shutil.copy(ROOT / script, tmp / script)
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
