#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rebel_tpu_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA GPU (written for
an H100, ``sm_90a``).  It

1. prints the card's name and power limit and builds the fused depth-2
   solve (``rebel_tpu_torch/kernels/grid2_cfr.cu``: the CFR kernel
   ``grid2_cfr``, the fictitious-play kernel ``grid2_fp`` and the
   two-group CFR kernel ``grid2_cfr_il2``, each in f32 and with bf16
   operands) with ``nvcc``; prints each instantiation's registers, spills
   and shared memory at the main path's lane block, and the tensor-core
   instructions (``HGMMA``, ``HMMA``) in its machine code: ``HGMMA`` in
   every bf16 instantiation, neither in an f32 one;
2. ``cfr-checks``: holds ``grid2_cfr`` against its plain PyTorch version
   (``solving.grid2p.solve_reference``) on the card at 1x4f, B=256, with
   fresh nets whose LayerNorm scale and bias are drawn from a seed too:
   f32 with LayerNorm, f32 without LayerNorm, no net, bf16 with the fast
   GELU, DCFR (plain and clamped), CFR without discounts, and 1 and 3
   hidden layers; over 4 iterations to an absolute limit and over 64 iterations
   (1024 without a net) by statistics limited by a
   plain(card)-vs-plain(cpu) control;
3. ``fp-checks``: the same for ``grid2_fp``: plain, linear and optimistic
   linear FP, no net, bf16;
4. ``cfr-selfplay``: trains the 1x4f 256x2 CFR self-play trainer at full
   width (1024 iterations, 1024 lanes, bf16 MLP, batch 512) for burn-in
   and two epochs through ``grid2_cfr``;
5. ``cfr-shapes``: holds ``grid2_cfr`` to its plain version at that path's
   shapes (4 iterations on random states; 1024 iterations on the walked
   episodes), and times both, and the kernel with an f32 MLP;
6. ``eval``: evaluates the repo's two trained 1x4f nets by the paper
   protocol (``eval.recursive_eval.run_eval``: 1024 subgame iterations,
   depth-2 subgames, kernel engine, bf16 MLP, f32 solve) at 256 of its
   1024 repeats: linear CFR with ``r4_1x4cfr/epoch990.params`` and linear FP
   with ``r5_1x4fp/epoch800.params``, each beside a zero-net control, and
   prints the exploitability by repeat count with the launches, the
   kernel seconds (CUDA events) and the wall seconds;
7. ``exploit-check``: runs the same evaluation at 16 repeats once through
   the kernels and once through their plain version on the card, and
   holds the two exploitabilities to each other: a quantity that does not
   drift with the iterates' chaos;
8. ``fp-selfplay``: burn-in and one epoch of the same trainer with linear
   FP through ``grid2_fp``, then ``grid2_fp`` against its plain version
   at that path's shapes, timed;
9. ``knob-checks``: the kernel's options on the card at 1x4f, B=256,
   against ``solve_reference`` with the same option: every ``gelu`` with
   f32 and bf16 operands and every ``ablate``, on a net with and without
   LayerNorm (4 iterations to the absolute limit, 64 by the statistics).
   Then, on the walked episodes of phase 4 over 64 and 1024 iterations in
   f32 and bf16: every ``mlp_chunks`` and ``interleave=2`` give the same
   bits as the default (``torch.equal`` on all three outputs); a layout
   that does not fit a block's shared memory (the lanes' state beside the
   bf16 weights, or beside the f32 MLP's rows and ring) raises before any
   launch; and
   ``grid2_cfr_il2`` is held to its plain version and timed at the
   self-play path's shapes;
10. ``bench``: runs the generation benchmark
   (``python -m rebel_tpu_torch.bench``) at full width: the CFR headline
   with its FP and no-net sides, ``--interleave 2``, and the three
   ablations, and prints every JSON line;
11. ``run-entry``: trains the way users do, through the run entry
   (``rebel_tpu_torch.run``, in process) over ``conf/liars_sp.yaml`` with
   the round-5 overrides (``selfplay.engine=pallas
   selfplay.net_compute_dtype=bf16 env.subgame_params.use_cfr=true``) at
   full width: two epochs with checkpoints and an exploit evaluation at
   epoch 0, then ``--mode start_continue`` to a third epoch with its own
   evaluation; holds the experiment dir's files, the JAX package's metric
   names, both exploitabilities in [0, 2], the resume (epoch 2 from the
   checkpoint, the ring's count carried on) and ``ckpt/epoch2.params``
   against the live net, the resumed run's state (the net, the optimizer,
   the replay ring) against a straight run of three epochs with
   ``torch.equal``, and prints the epochs' generation, training,
   evaluation (by part) and checkpoint seconds and bytes;
12. ``games``: the larger games (1x5f, 1x6f, 2x3f), CFR and FP, bf16 and
   f32, each with the repo's trained 256x2 net of that game and solver:
   prints the lane block the wrapper chooses and its shared memory, holds
   the kernel against its plain version over 4 iterations (the 1x4f
   limits) and over 64 (the statistics against a plain(card)-vs-plain(cpu)
   control; FP with at most 2% flip lanes, as below), and times one
   launch of 1024 lanes beside
   the bound of the game's MLP FLOP; then holds pairs of lane blocks to
   the same bits over 1024 iterations;
13. ``games-exploit``: at 2x3f (the smallest lane blocks and H = 9), over
   the path's 1024 subgame iterations: CFR and FP in bf16 by the
   statistics of the 1x4f path checks against a plain(card)-vs-plain(cpu)
   control, and phase 7's FP check (2%) with an f32 MLP on 4 repeats;
14. ``run-entry-2x3``: the run entry with the round-5 overrides at
   ``env.num_dice=2 env.num_faces=3``: burn-in and one epoch through the
   fused solve at its chosen lane block, and the checkpoint;
15. ``fast-check``: the ``fast`` engine (plain PyTorch, f32): a 16-repeat
   evaluation of each 1x4f net against the kernel with an f32 MLP, with
   phase 7's limits (CFR over 16 subgame iterations, FP over 1024), and
   ``bench --layout batch_first`` for 2 steps;
16. ``spmd``: the SPMD path (``Trainer.run_spmd``,
   ``rebel_tpu_torch.parallel``) with the round-5 overrides at full width:
   (a) at world size 1 over NCCL in this process, two epochs and a
   resume to a third, whose net, optimizer, ring, episodes and generator
   are held to a straight run of three with ``torch.equal``, with the
   epochs' seconds by part; (b) two ranks sharing the card over gloo
   through the run entry (``launcher.num_processes=2 launcher.spmd=true
   max_epochs=2 exploit_every=1``): its files, rank 0's exploitability,
   every rank's net equal after each epoch and ``grid2_cfr`` launched on
   every rank; (c) the SPMD train step on two gloo ranks: the averaged
   gradient against one process's on both batches, the nets equal across
   the ranks; (d) the ``fast`` engine with the hands split over two gloo
   ranks (1x4f, f64) against the unsplit engine;
17. prints the whole run's seconds, one ``{"kernels": [...]}`` line with
   the three kernels and ``{"ok": true, "device": {...}}`` as the last
   line.

The launch counts of the kernels are set to 0 just before each of the
paths (4, 6 for each net, 8, 10, each run of 11, 14, 16a) and read just
after; a kernel that a path should run and did not fails the run.  In 11,
``grid2_cfr`` must run in generation (bf16) and in the evaluation (f32).
In 16b each rank counts its own launches, which the run entry writes
into ``result.json`` (``kernel_launches``, one entry a rank); a rank that
launched ``grid2_cfr`` no time fails the run, and the ranks' counts join
the kernels line's.

``--phases a,b`` runs only the named phases (and the build); such a run
prints no result line.

It exits non-zero, printing no result, without CUDA, outside a checkout,
or when any check fails.  Weights of the trainers and the checks' data
are random, made from seeds.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12  # outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain version on the same inputs.  Two checks per mode:
#
# * Over CHECK_ITERS iterations, every output to an absolute limit.  f32:
#   the two sum in another order and the card's expf and rsqrtf round
#   differently.  bf16: both round the same operands to bf16, but a sum
#   on a rounding boundary of the next layer's bf16 operand can round the
#   other way, a bf16 ulp of an activation that regret matching scales
#   up, and the more so the larger the trained net's values: so a fresh
#   net (TOL_BF16) and the main path's trained net (TOL_BF16_TRAINED) have
#   limits of their own.  A control holds the kernel in f32 against the
#   plain version in bf16 on the same inputs and must exceed the limit,
#   so the limit tells operands rounded to bf16 from operands that are not.
# * Over LONG_ITERS iterations (and the main path's 1024), statistics that
#   stay stable where single values do not.  CFR's last iterates amplify
#   f32 rounding about twofold every few iterations, so two correct f32
#   implementations (the plain version on the card and on the CPU) differ
#   by up to 0.1 on some lanes' policies by 64 iterations.  Checked: the
#   mean and the max abs diff of rvm (a running mean, which damps the
#   chaos) and, over 64 iterations, the share of lanes whose snapshots
#   differ anywhere by more than LANE_TOL (by 1024 iterations that share
#   is about a half for two correct versions, so it is only printed
#   there).  Each is held to LONG_FACTOR times the same statistic of the
#   plain(card)-vs-plain(cpu) control, or to its floor if that is larger.
#   Limits and the readings behind them: PERF.md, Findings.
#
# Fictitious play averages best responses, so its iterates do not amplify
# rounding; what it has instead is discontinuity: a rounding difference
# in a leaf value flips a best response on a lane whose two best actions
# are nearly tied, and that lane's average policy then differs by that
# iteration's weight.  Such lanes are counted apart (FP_TIE_SHARE) and all
# others hold the absolute limit over 4 and over 64 iterations.  With a
# trained net of a larger game and bf16 operands a flip moves rvm past
# the statistics' floors: on the CPU each legal change of the plain
# version's arithmetic (f64 sums; the kernel's LayerNorm and GELU
# rounding) moves one lane of 256 at 2x3f by 6e-4 to 4.9e-3 (PERF.md).
# So the games' statistics count the lanes past the rvm_max limit as flip
# lanes, at most FP_TIE_SHARE of them, and hold the others.
CHECK_ITERS = 4
LONG_ITERS = 64
# Without a net the iterates stay close to deterministic, so the no-net
# mode is held over the main path's iteration count as well, where a
# discount or running-mean error that starts late shows.
NONET_ITERS = 1024
TOL_F32 = 1e-4
TOL_BF16 = 1e-3
TOL_BF16_TRAINED = 2.5e-2
LANE_TOL = 0.05
LONG_FACTOR = {"rvm_mean": 3.0, "rvm_max": 10.0, "lanes": 4.0}
LONG_FLOOR = {"rvm_mean": 1e-5, "rvm_max": 3e-3, "lanes": 0.02}
# Walked episodes may hold exact ties between two actions' values, which
# rounding breaks one way in one version and another way in the other:
# such a lane's policy differs already within CHECK_ITERS iterations.  At
# most this share of lanes may be such ties; they are left out of the
# 1024-iteration statistics.
TIE_SHARE = 0.01
FP_TIE_SHARE = 0.02
# FP's limits for a fresh net; the kernel's and the plain version's best
# responses see leaf values that agree to a few f32 ulps, so the limits
# sit well below CFR's.  Readings and mutants: PERF.md.
TOL_FP_F32 = 1e-5
TOL_FP_BF16 = 1e-4
# FP over the self-play path's 1024 iterations, kernel against plain
# version on the card: FP does not drift, so its floors sit a few times
# above the correct kernel's readings and below those of a late-starting
# mutant (PERF.md).  Like CFR's, each limit is FP_LONG_FACTOR times the
# same statistic of the plain(card)-vs-plain(cpu) control where that is
# larger: the reading follows the episodes a trainer leaves, and so does
# the control.
FP_LONG_LIMIT = {"rvm_mean": 1e-6, "rvm_max": 1.5e-3, "lanes": 0.02}
FP_LONG_FACTOR = {"rvm_mean": 10.0, "rvm_max": 10.0, "lanes": 4.0}
CONTROL_LANES = 64  # lanes of the 1024-iteration control run on the CPU

# The evaluation (phase 6).  Exploitabilities that the JAX package
# measured on the same two nets (results/PROTOCOL.md): the full-tree
# solve in f32, and the sampled evaluation at 1024 repeats with its fused
# kernel (bf16 MLP) and with its grid engine (f32).
EVAL_CELLS = {
    "cfr": dict(ckpt="results/liars_sp/r4_1x4cfr/ckpt/epoch990.params",
                full_tree=0.000331, jax_kernel_bf16=0.007618,
                jax_grid_f32=0.022356),
    "fp": dict(ckpt="results/liars_sp/r5_1x4fp/ckpt/epoch800.params",
               full_tree=0.009909, jax_kernel_bf16=0.028013,
               jax_grid_f32=0.036275),
}
# A quarter of the protocol's 1024 repeats (34 launches a net and not
# 136), so that the script keeps its length while it grows; the whole
# protocol is `python -m rebel_tpu_torch.eval.eval_all`, and its readings
# on these nets are in PERF.md.
EVAL_REPEATS = 256
# The full-tree exploitability after 1024 iterations, as a band around the
# JAX package's f32 reading.  FP's is reproducible: within 5%.  CFR's is
# not: its iterates are chaotic (see above), and the JAX package itself
# reads 0.000331 in f32 on a TPU, 0.001369 in f32 and 0.000436 in f64 on a
# CPU (PERF.md), so the band only tells a solve that converged from one
# that did not.  What holds the full-tree solvers tightly is GOLDEN: the
# exploitability at every power-of-two iteration of a 64-iteration f64
# solve on the card against the fixtures of the C++ implementation, at the
# tolerance of tests/test_golden_parity.py.
FULL_TREE_BAND = {"cfr": (0.5, 5.0), "fp": (0.95, 1.05)}
GOLDEN = {"cfr": "tests/golden/cfr_linear_1x4.json",
          "fp": "tests/golden/fp_linear_1x4.json"}
GOLDEN_ATOL, GOLDEN_RTOL = 2e-6, 1e-5
# The exploitability at EVAL_REPEATS must lie between BAND_LO times the
# lower and BAND_HI times the higher of the JAX package's two 1024-repeat
# readings for the net.  The band is wide because those two readings
# differ by 1.3x (FP) to 2.9x (CFR) through arithmetic alone, and wider
# than it was at 1024 repeats (0.5 and 1.5) because a quarter of the
# repeats doubles the sampling error: the port read 0.008054 at 256
# repeats and 0.010000 at 1024 on the CFR net; readings in PERF.md.
BAND_LO, BAND_HI = 0.4, 1.75
ZERO_NET_REPEATS = 64
# The check that does not drift (phase 7): repeats, and the limit on
# |exploitability(kernel) - exploitability(plain)| relative to the plain
# version's.  Readings and mutants: PERF.md.
EXPLOIT_REPEATS = 16
EXPLOIT_RTOL = {"cfr": 0.10, "fp": 0.02}

# The options' checks (phase 9).  Over LONG_ITERS iterations they hold the
# MOST_LANES quantile of the lanes' rvm diffs, not the mean and the max, to
# MOST_LANES_TOL: a few times above the correct kernel's readings over 24
# modes (at most 3.3e-06 in f32 and 1.7e-05 with bf16 operands, while the
# worst lane reads up to 5e-02; PERF.md); the
# kernel with "cheaperf" and gelu="exact" must be PRECEDENCE_FACTOR times
# closer to the plain fast GELU than to the plain exact one; and the values
# of mlp_chunks held to the default bit for bit are, by lane block, some
# at the default lane block of 8 and 1 and 2 at a lane block of 2 (neither
# MLP stages a group of pairs, so every value fits and 1 is the default
# at 1x4f in f32 and bf16 alike).
MOST_LANES = 0.9
MOST_LANES_TOL = {"f32": 1e-5, "bf16": 1e-4}
PRECEDENCE_FACTOR = 4
KNOB_CHUNKS = {8: (2, 4, 7, 28), 2: (1, 2)}

# The instantiations of grid2_kernel<WT, FP, NG> by their mangled
# names' template arguments (FP, NG), and the MLP's operands WT (the f32
# ones also run without a net).
INSTANTIATION = re.compile(
    r"grid2_kernelI(13__nv_bfloat16|f)Lb([01])ELi([12])E")
KERNEL_OF = {("0", "1"): "grid2_cfr", ("1", "1"): "grid2_fp",
             ("0", "2"): "grid2_cfr_il2"}
OPERANDS_OF = {"13__nv_bfloat16": "bf16", "f": "f32"}
INSTANTIATIONS = 6

PHASES = ("cfr-checks", "fp-checks", "cfr-selfplay", "cfr-shapes", "eval",
          "exploit-check", "fp-selfplay", "knob-checks", "bench", "run-entry",
          "games", "games-exploit", "run-entry-2x3", "fast-check", "spmd")

# The larger games (phases 12-14): the repo's trained 256x2 net of each
# game and solver.  Their checks run at GAME_LANES lanes, the controls of
# the LONG_ITERS checks on GAME_CONTROL_LANES of them, on the CPU.
GAME_NETS = {
    (1, 5): {"cfr": "results/liars_sp/r5_1x5cfr/ckpt/epoch990.params",
             "fp": "results/liars_sp/r4_1x5fp/ckpt/epoch990.params"},
    (1, 6): {"cfr": "results/liars_sp/r5_1x6cfr/ckpt/epoch990.params",
             "fp": "results/liars_sp/r4_1x6fp/ckpt/epoch990.params"},
    (2, 3): {"cfr": "results/liars_sp/r4_2x3cfr/ckpt/epoch990.params",
             "fp": "results/liars_sp/env.num_dice=2-env.num_faces=3-"
                   "exploit_every=100-max_epochs=1000-selfplay.batch=-60727016"
                   "/ckpt/epoch860.params"},
}
GAME_LANES = 256
GAME_CONTROL_LANES = 64
# Phase 13, at 2x3f over the path's 1024 subgame iterations.  bf16 is
# held lane by lane (256 lanes, the control on GAMES_1024_CONTROL_LANES of
# them on the CPU).  Phase 7's exploitability check is not a check of
# bf16 there: two correct plain versions, with the MLP's sums in f32 and
# exact in f64, read a 4-repeat evaluation 73% (FP) and 47% (CFR) apart
# (`chip_studies.py eval-sum-order`, PERF.md), because a bf16 rounding
# that goes the other way flips a best response or a chaotic CFR
# iterate.  With an f32 MLP FP does not flip (kernel and plain version
# 1.5e-4 apart), so FP's check runs in f32, on GAMES_EXPLOIT_REPEATS
# repeats: the plain version takes about 26 s a repeat there.  CFR's f32
# iterates are chaotic (kernel and plain version 111% apart on the same
# 4 repeats), so CFR is held by the lane statistics only.
GAMES_EXPLOIT_REPEATS = 4
GAMES_1024_CONTROL_LANES = 32
# Lanes a solve of the plain version takes there: its iterations are a
# Python loop of small launches, which larger solves amortise.
GAMES_PLAIN_CHUNK = 16384
# The lane block must not change a lane's arithmetic: at 2x3f and 1x6f
# over the path's iterations, each pair of blocks gives the same bits
# (game, solver, operand type, blocks).
LANE_BLOCK_PAIRS = (((2, 3), "cfr", "bf16", (1, 2)),
                    ((1, 6), "fp", "bf16", (1, 2)),
                    ((2, 3), "fp", "f32", (1, 2)),
                    ((2, 3), "cfr", "f32", (1, 4)))
# The fast engine's check (phase 15) over each solver's subgame
# iterations: CFR's f32 iterates are chaotic, so that two correct f32
# engines read a 16-repeat evaluation 10.7% apart over 64 iterations and
# 74% apart over 256 (PERF.md); so the card holds CFR over 16 iterations
# and the CPU tests hold the fast engine's arithmetic to the JAX
# package's step by step.  FP does not drift and is held over the path's
# 1024.
FAST_CHECK_ITERS = {"cfr": 16, "fp": 1024}
# The run entry at 2x3 (phase 14): the round-5 overrides, burn-in and one
# epoch with its checkpoint, no exploit evaluation (the recursion over the
# 2x3 tree is a host loop of unknown length).
RUN_ENTRY_2X3_ARGS = ["selfplay.engine=pallas",
                      "selfplay.net_compute_dtype=bf16", "env.num_dice=2",
                      "env.num_faces=3", "exploit=false", "checkpoint_every=1",
                      "max_epochs=1", "stall_timeout_s=600"]

# The run entry (phase 11): conf/liars_sp.yaml with the round-5 overrides
# (scripts/round5_run.sh), cut to two epochs and a resumed third.
ROUND5 = ["selfplay.engine=pallas", "selfplay.net_compute_dtype=bf16",
          "env.subgame_params.use_cfr=true"]
RUN_ENTRY_ARGS = ROUND5 + ["checkpoint_every=1", "exploit_every=2",
                           "eval_num_repeats=8", "stall_timeout_s=600"]

# The SPMD path (phase 16), conf/liars_sp.yaml with the round-5
# overrides at full width.  (a) Trainer.run_spmd in this process at world
# size 1 over NCCL, without exploit evaluations: two epochs, a resume to a
# third, and a straight run of three.  (b) Two ranks sharing the card over
# gloo through the run entry, an exploit evaluation on rank 0 at both
# epochs.  (c) The SPMD train step on two gloo ranks over fixed rings of
# SPMD_RING_ROWS rows with given sample slots, SPMD_STEPS steps: the
# averaged gradient against one process's on both batches put together
# (f32; the sums run in another order), the nets equal across the ranks.
# (d) The fast engine in f64 at 1x4f over SPMD_HANDS_ITERS subgame
# iterations with the hands split over two gloo ranks, against the
# unsplit engine at the JAX package's tolerance
# (tests/test_hands_sharding.py).
SPMD_ARGS = ROUND5 + ["exploit=false", "checkpoint_every=1"]
SPMD_RUN_ARGS = ROUND5 + ["launcher.num_processes=2", "launcher.spmd=true",
                          "max_epochs=2", "exploit_every=1",
                          "stall_timeout_s=600"]
SPMD_TIMEOUT = 600  # seconds a group of ranks may take
SPMD_RING_ROWS, SPMD_STEPS, SPMD_GRAD_RTOL = 4096, 3, 1e-6
SPMD_HANDS_LANES, SPMD_HANDS_ITERS, SPMD_HANDS_ATOL = 1024, 16, 1e-12

# Metric names of the JAX package's epoch (tests/test_trainer.py:47-57 and
# its epoch loop), and those of an exploit epoch.
EPOCH_METRICS = ("epoch", "loss/train", "optim/lr", "optim/grad_max",
                 "optim/grad_mean", "optim/grad_clip_ratio", "buffer/size",
                 "buffer/added", "bps/train", "bps/train_examples", "bps/gen",
                 "bps/gen_examples", "timing/gen", "timing/train",
                 "shares/train_initial")
EXPLOIT_METRICS = ("exploitability_last", "exploitability_avg",
                   "timing/exploit")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def instantiation(mangled: str) -> tuple[str, str] | None:
    """``(kernel name, MLP operands)`` of a mangled grid2_kernel name."""
    m = INSTANTIATION.search(mangled)
    if m is None:
        return None
    return KERNEL_OF[m[2], m[3]], OPERANDS_OF[m[1]]


def build_report(build, grid2p, game, failures: list) -> None:
    """Per instantiation: registers and spills (``-Xptxas -v``), shared
    memory at the main path's lane block of 8 with a 256x2 net and the
    default ``mlp_chunks`` (the wrapper's reckoning, which it holds equal
    to the kernel's), and the tensor-core instructions in its machine
    code."""
    props: dict = {}
    name = None
    for line in build.build_log("grid2_cfr").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = instantiation(m[1])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            props.setdefault(name, {}).update(spill_stores=int(m[1]),
                                              spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props.setdefault(name, {})["registers"] = int(m[1])
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    sass = None
    if cuobjdump.exists():
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path("grid2_cfr"))],
            capture_output=True, text=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                name = instantiation(m[1])
                if name:
                    props.setdefault(name, {}).update(HGMMA=0, HMMA=0)
            elif name and "HGMMA" in line:
                props[name]["HGMMA"] += 1
            elif name and "HMMA" in line:
                props[name]["HMMA"] += 1
    else:
        print(f"  cuobjdump not found at {cuobjdump}: the tensor-core "
              "instructions are not counted")
    params = {"grid2_fp": False}
    for (kernel, operands), got in sorted(props.items()):
        groups = 2 if kernel == "grid2_cfr_il2" else 1
        smem = grid2p.smem_layout(
            game, 8, params.get(kernel, True), 256, 2, operands == "bf16",
            groups)["total"]
        print(f"  {kernel} {operands}: "
              f"{got.get('registers')} registers, spill stores "
              f"{got.get('spill_stores')} B, spill loads "
              f"{got.get('spill_loads')} B, shared memory {smem} B at lane "
              f"block 8; HGMMA {got.get('HGMMA', 'not counted')}, HMMA "
              f"{got.get('HMMA', 'not counted')}")
        tensor = (got.get("HGMMA", 0), got.get("HMMA", 0))
        if sass is not None and (tensor[0] == 0 if operands == "bf16"
                                 else any(tensor)):
            failures.append(f"{kernel} {operands}: {got.get('HGMMA', 0)} "
                            f"HGMMA and {got.get('HMMA', 0)} HMMA "
                            "instructions")
    if len(props) != INSTANTIATIONS:
        failures.append(f"build: {len(props)} instantiations of grid2_kernel "
                        f"found, expected {INSTANTIATIONS}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    opts = ap.parse_args()
    phases = [p for p in opts.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        fail(f"unknown phase in {phases}; known: {PHASES}")
    whole = set(phases) == set(PHASES)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs on the card only")
    if not (ROOT / "rebel_tpu_torch" / "kernels" / "grid2_cfr.cu").is_file():
        fail("run chip_smoke.py from the root of a checkout of the repo")
    sys.path.insert(0, str(ROOT))

    from rebel_tpu_torch.eval import recursive, recursive_eval
    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.kernels import build
    from rebel_tpu_torch.nets.cfv_net import CFVNet
    from rebel_tpu_torch.nets.value_nets import zero_value_fn
    from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
    from rebel_tpu_torch.solving import exploitability, grid2p
    from rebel_tpu_torch.solving.core import RootCtx, SolverContext
    from rebel_tpu_torch.solving.params import SubgameSolvingParams
    from rebel_tpu_torch.solving.solver import build_solver
    from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig
    from rebel_tpu_torch.tree import unroll_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures: list[str] = []
    phase_s: dict[str, float] = {}  # host seconds per phase
    mark = start = time.perf_counter()
    KERNELS = grid2p.KERNEL_NAMES
    # Per kernel: launches summed over the paths, and what the shape
    # phases measured.
    launches = dict.fromkeys(KERNELS, 0)
    measured: dict[str, dict] = {}

    def lap(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        phase_s[name] = round(now - mark, 1)
        mark = now

    def reset_counts() -> None:
        grid2p.solve.launches = 0
        for k in KERNELS:
            grid2p.solve.launches_by_kernel[k] = 0

    def read_counts(path: str, *runs: str, expect: int | None = None) -> int:
        """Add the path's launches to the totals; every kernel of ``runs``
        must have been launched (``expect`` times, if given).  Returns
        the launches of the first."""
        got = dict(grid2p.solve.launches_by_kernel)
        for k in KERNELS:
            launches[k] += got[k]
        print(f"  launches on this path: {got}")
        for k in runs:
            if got[k] == 0:
                failures.append(f"{path} launched {k} no time")
            elif expect is not None and got[k] != expect:
                failures.append(f"{path}: {got[k]} launches of {k}, "
                                f"expected {expect}")
        return got[runs[0]]

    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build.load("grid2_cfr")
    print(f"kernel build: grid2_cfr.cu ({', '.join(KERNELS)}) "
          f"{build.build_seconds['grid2_cfr']:.1f} s")
    game = LiarsDice(1, 4)
    A, H = game.num_actions, game.num_hands
    build_report(build, grid2p, game, failures)

    lap("build")

    def random_inputs(batch: int, num_iters: int, seed: int, g_=None):
        """Random roots (bids, players), Dirichlet(1) beliefs and stop
        iterations of ``g_`` (default 1x4f) on the card."""
        g_ = g_ or game
        g = torch.Generator().manual_seed(seed)
        bids = torch.randint(-1, g_.num_actions - 1, (batch,), generator=g)
        players = torch.randint(0, 2, (batch,), generator=g)
        expo = -torch.log(torch.rand((batch, 2, g_.num_hands), generator=g))
        beliefs = expo / expo.sum(-1, keepdim=True)  # Dirichlet(1)
        t_stop = torch.randint(0, num_iters + 1, (batch,), generator=g)
        return [x.to(dev) for x in (bids, players, beliefs, t_stop)]

    def max_diff(a, b) -> float:
        return max(float((x.cpu() - y.cpu()).abs().max())
                   for x, y in zip(a, b))

    def lane_diff(a, b):
        """Per lane: max abs diff over all three outputs."""
        return torch.stack([(x.cpu() - y.cpu()).abs().flatten(1).amax(1)
                            for x, y in zip(a, b)]).amax(0)

    def finite(out) -> bool:
        return all(bool(torch.isfinite(x).all()) for x in out)

    def snap_diff(a, b):
        """Per lane: max abs diff of the snapshots."""
        return torch.maximum(
            (a.snap0.cpu() - b.snap0.cpu()).abs().flatten(1).amax(1),
            (a.snap1.cpu() - b.snap1.cpu()).abs().flatten(1).amax(1))

    def lane_stats(a, b, keep) -> dict:
        """rvm's mean and max abs diff and the share of lanes whose
        snapshots differ anywhere by more than LANE_TOL, over the lanes
        ``keep`` (a bool mask)."""
        rvm = (a.rvm.cpu() - b.rvm.cpu()).abs()[keep]
        snap = snap_diff(a, b)[keep]
        return {"rvm_mean": float(rvm.mean()), "rvm_max": float(rvm.max()),
                "lanes": float((snap > LANE_TOL).float().mean())}

    def long_check(label, out, ref, ref_part, cpu, keys=tuple(LONG_FLOOR),
                   keep=None, keep_part=None, factor=LONG_FACTOR,
                   floor=LONG_FLOOR, flips=None) -> None:
        """Kernel ``out`` vs plain ``ref`` on the card, limited by the
        control: plain ``ref_part`` (the same lanes as ``cpu``) vs the
        plain version on the CPU, ``factor`` times, or ``floor``.
        ``keep``/``keep_part``: lanes counted.  ``flips`` (FP): the lanes
        whose rvm differs by more than the rvm_max limit are flip lanes,
        at most that share of the counted lanes, and the statistics are
        taken over the others."""
        if keep is None:
            keep = torch.ones(out.rvm.shape[0], dtype=torch.bool)
        if keep_part is None:
            keep_part = torch.ones(cpu.rvm.shape[0], dtype=torch.bool)
        ctl = lane_stats(ref_part, cpu, keep_part)
        ok, parts = finite(out), []
        if flips is not None:
            lim = max(factor["rvm_max"] * ctl["rvm_max"], floor["rvm_max"])
            d = (out.rvm.cpu() - ref.rvm.cpu()).abs().flatten(1).amax(1)
            flip = keep & (d > lim)
            share = float(flip.sum()) / max(1, int(keep.sum()))
            ok = ok and share <= flips
            worst = ", ".join(f"lane {int(i)} {float(d[i]):.3e}"
                              for i in torch.nonzero(flip).flatten()[:8])
            parts.append(f"{int(flip.sum())} flip lanes (share {share:.3e}, "
                         f"limit {flips:.0e}{'; ' + worst if worst else ''})")
            keep = keep & ~flip
        got = lane_stats(out, ref, keep)
        for key, x in got.items():
            if key in keys:
                lim = max(factor[key] * ctl[key], floor[key])
                ok = ok and x <= lim
                parts.append(f"{key}={x:.3e} (control {ctl[key]:.3e}, "
                             f"limit {lim:.3e})")
            else:
                parts.append(f"{key}={x:.3e} (control {ctl[key]:.3e}, "
                             "not checked)")
        print(f"check {label}: {', '.join(parts)} {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"kernel check {label}")

    def short_check(label, out, ref, tol) -> float:
        diff = max_diff(out, ref)
        ok = finite(out) and diff <= tol
        print(f"check {label}: max_abs_diff={diff:.3e} limit={tol:.1e} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"kernel check {label}")
        return diff

    def most_lanes_check(label, out, ref, tol) -> None:
        """Over LONG_ITERS iterations with no control behind it: the mean
        and the max of a drifting solve follow its worst lane (the same
        arithmetic reads 20 times more at one seed than at another,
        PERF.md), so hold what most lanes do: the MOST_LANES quantile over
        lanes of the lane's largest rvm diff to ``tol``, and the share of
        lanes whose snapshots differ by more than LANE_TOL to its floor."""
        d = (out.rvm.cpu() - ref.rvm.cpu()).abs().flatten(1).amax(1)
        q50, q = (float(x) for x in torch.quantile(
            d, torch.tensor([0.5, MOST_LANES])))
        lanes = float((snap_diff(out, ref) > LANE_TOL).float().mean())
        ok = finite(out) and q <= tol and lanes <= LONG_FLOOR["lanes"]
        print(f"check {label}: lane rvm diff median={q50:.3e} "
              f"q{MOST_LANES:.2f}={q:.3e} (limit {tol:.1e}) "
              f"max={float(d.max()):.3e}, lanes={lanes:.3e} (limit "
              f"{LONG_FLOOR['lanes']:.1e}) {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"kernel check {label}")

    def tie_check(label, out, ref, tol, share=FP_TIE_SHARE) -> float:
        """FP: every lane within ``tol`` but for a counted share of tie
        lanes (a flipped best response).  Returns the max abs diff over
        the other lanes."""
        d = lane_diff(out, ref)
        ties = d > tol
        rest = float(d[~ties].max()) if bool((~ties).any()) else 0.0
        got = float(ties.float().mean())
        ok = finite(out) and got <= share
        print(f"check {label}: max_abs_diff={rest:.3e} limit={tol:.1e} on "
              f"{int((~ties).sum())} lanes; {int(ties.sum())} tie lanes "
              f"(share {got:.3e}, limit {share:.0e}) "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"kernel check {label}")
        return rest

    def precision_control(label, args, tol) -> None:
        """The kernel in f32 against the plain version in bf16: must miss
        ``tol``, or that limit would pass a kernel that skips the bf16
        rounding of its operands."""
        diff = max_diff(grid2p.solve(*args, torch.float32),
                        grid2p.solve_reference(*args, torch.bfloat16))
        ok = diff > tol
        print(f"control {label}: kernel f32 vs plain bf16 max_abs_diff="
              f"{diff:.3e}, must exceed {tol:.1e} {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"bf16 limit does not separate ({label})")

    def cfr(num_iters, **kw):
        kw.setdefault("linear_update", True)
        return SubgameSolvingParams(num_iters=num_iters, max_depth=2,
                                    use_cfr=True, **kw)

    def fp(num_iters, **kw):
        kw.setdefault("linear_update", True)
        return SubgameSolvingParams(num_iters=num_iters, max_depth=2,
                                    use_cfr=False, **kw)

    def fresh_net(layers, use_ln, seed, seeded_ln=False):
        """A 256-wide net of ``layers`` hidden layers from ``seed``, on the
        CPU and on the card.  ``seeded_ln``: LayerNorm's scale and bias
        drawn from the seed too, U(0.5, 1.5) and U(-0.5, 0.5) per column,
        not 1 and 0, so that a kernel that reads them off by a column
        shows."""
        if not layers:
            return None, None
        g = torch.Generator().manual_seed(seed)
        net = CFVNet(game, 256, layers, use_ln, generator=g)
        if seeded_ln:
            with torch.no_grad():
                for _, ln in net.hidden_layers():
                    if ln is not None:
                        ln.weight.copy_(0.5 + torch.rand(256, generator=g))
                        ln.bias.copy_(torch.rand(256, generator=g) - 0.5)
        return net, copy.deepcopy(net).to(dev)

    # ------------------------------------ 2. grid2_cfr vs plain version
    if "cfr-checks" in phases:
        dcfr = dict(linear_update=False, dcfr=True, dcfr_alpha=1.5,
                    dcfr_beta=0.5, dcfr_gamma=2.0)
        dcfr_clamped = dict(linear_update=False, dcfr=True, dcfr_alpha=5.0,
                            dcfr_beta=-5.0, dcfr_gamma=1.0)
        # name, solver params, hidden layers (0: no net), LayerNorm, dtype
        modes = [
            ("f32_ln", {}, 2, True, torch.float32),
            ("f32_noln", {}, 2, False, torch.float32),
            ("nonet", {}, 0, True, torch.float32),
            ("bf16_ln_fastgelu", {}, 2, True, torch.bfloat16),
            ("f32_dcfr", dcfr, 2, True, torch.float32),
            ("f32_dcfr_clamped", dcfr_clamped, 2, True, torch.float32),
            ("f32_plain_cfr", dict(linear_update=False), 2, True,
             torch.float32),
            ("f32_1layer", {}, 1, True, torch.float32),
            ("f32_3layers", {}, 3, True, torch.float32),
        ]
        for k, (name, kw, layers, use_ln, dtype) in enumerate(modes):
            net, net_dev = fresh_net(layers, use_ln, 10 + k, seeded_ln=True)
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
            for iters in ((CHECK_ITERS, LONG_ITERS)
                          + ((NONET_ITERS,) if net is None else ())):
                inputs = random_inputs(256, iters, 20 + k)
                args = (game, cfr(iters, **kw), *inputs, net_dev)
                out = grid2p.solve(*args, dtype)
                ref = grid2p.solve_reference(*args, dtype)
                label = f"cfr {name}: B=256 iters={iters}"
                if iters == CHECK_ITERS:
                    short_check(label, out, ref, tol)
                    if dtype == torch.bfloat16:
                        precision_control(label, args, tol)
                    continue
                cpu = grid2p.solve_reference(
                    game, cfr(iters, **kw), *[x.cpu() for x in inputs], net,
                    dtype)
                long_check(label, out, ref, ref, cpu)
        lap("cfr-checks")

    # ------------------------------------- 3. grid2_fp vs plain version
    if "fp-checks" in phases:
        # name, solver params, hidden layers (0: no net), dtype.  The last
        # mode holds the tie rule: without a net every pseudo-leaf is
        # worth exactly 0, and with point-mass beliefs every sum has one
        # term, so values that tie do so bit for bit in both versions, at
        # the root too, and the lowest tied action must win in both.
        modes = [
            ("plain_f32", dict(linear_update=False), 2, torch.float32),
            ("linear_f32", {}, 2, torch.float32),
            ("linear_optimistic_f32", dict(optimistic=True), 2,
             torch.float32),
            ("linear_nonet", {}, 0, torch.float32),
            ("linear_bf16", {}, 2, torch.bfloat16),
            ("linear_nonet_pointmass", {}, 0, torch.float32),
        ]
        for k, (name, kw, layers, dtype) in enumerate(modes):
            net, net_dev = fresh_net(layers, True, 40 + k, seeded_ln=True)
            tol = TOL_FP_BF16 if dtype == torch.bfloat16 else TOL_FP_F32
            for iters in (CHECK_ITERS, LONG_ITERS):
                inputs = random_inputs(256, iters, 50 + k)
                if name.endswith("pointmass"):
                    inputs[2] = (inputs[2] == inputs[2].amax(
                        -1, keepdim=True)).float()
                args = (game, fp(iters, **kw), *inputs, net_dev)
                out = grid2p.solve(*args, dtype)
                ref = grid2p.solve_reference(*args, dtype)
                label = f"fp {name}: B=256 iters={iters}"
                tie_check(label, out, ref, tol)
                if iters == CHECK_ITERS:
                    if dtype == torch.bfloat16:
                        precision_control(label, args, tol)
                    continue
                cpu = grid2p.solve_reference(
                    game, fp(iters, **kw), *[x.cpu() for x in inputs], net,
                    dtype)
                long_check(label, out, ref, ref, cpu)
        lap("fp-checks")

    # ----------------------------------------- 4./8. self-play trainers
    B = 1024
    ITERS = 1024

    def selfplay(name: str, sub, epochs: int):
        """Burn-in and ``epochs`` epochs of the 1x4f 256x2 trainer at full
        width through the kernel that solves ``sub``."""
        cfg = TrainerConfig(
            env=RecursiveSolvingParams(num_dice=1, num_faces=4,
                                       subgame_params=sub,
                                       random_action_prob=0.25,
                                       sample_leaf=True),
            n_hidden=256, n_layers=2, use_layer_norm=True,
            train_epoch_size=25600, train_batch_size=512, train_gen_ratio=4,
            selfplay_batch=B, net_compute_dtype=torch.bfloat16, seed=0,
            # No exploit evaluation and no validation snapshot (whose rows
            # are drawn from the generator): the stream and the numbers of
            # this path stay those of the trainer before the run entry.
            exploit=False, create_validation_set_every=0,
        )
        trainer = Trainer(cfg, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.run(max_epochs=epochs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        kernel = grid2p.kernel_name(sub)
        solve_ms = [s.elapsed_time(e) for s, e in trainer.engine.solve_events]
        mean_solve_ms = sum(solve_ms) / len(solve_ms)
        flops = grid2p.mlp_flops_per_lane_iter(
            game, cfg.n_hidden, cfg.n_layers) * B * sub.num_iters
        # timing/* are means over the epochs run.
        gen_s = metrics[-1]["timing/gen"] * len(metrics) + trainer.burn_in_s
        gen_examples = 2 * B * trainer.gen_steps
        train_s = metrics[-1]["timing/train"] * len(metrics)
        steps = trainer.steps_per_epoch * len(metrics)
        losses = [m["loss/train"] for m in metrics]
        print(f"{name}: 1x4f CFVNet 256x2 LN, linear "
              f"{'CFR' if sub.use_cfr else 'FP'} {sub.num_iters} iters, "
              f"{B} lanes, bf16 MLP, batch {cfg.train_batch_size}: "
              f"burn-in + {len(metrics)} epochs in {wall_s:.2f} s, "
              f"{trainer.gen_steps} batch_steps")
        read_counts(name, kernel, expect=trainer.gen_steps)
        print(f"  lane block {grid2p.solve.last_lane_block}")
        print(f"  solve ms per batch_step: {mean_solve_ms:.3f} "
              f"(min {min(solve_ms):.3f}, max {max(solve_ms):.3f}; "
              "CUDA events)")
        print(f"  subgame-iters/s: "
              f"{B * sub.num_iters / (mean_solve_ms / 1e3):.4e}")
        print(f"  MLP FLOP/s: {flops / (mean_solve_ms / 1e3):.4e} "
              f"({flops:.4e} FLOP per batch_step)")
        print(f"  examples/s: {gen_examples / gen_s:.1f} "
              f"({gen_examples} examples, generation {gen_s:.2f} s)")
        print(f"  train steps/s: {steps / train_s:.2f} ({steps} steps)")
        print(f"  loss/train per epoch: {losses}")
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"{name}: non-finite training loss")
        rp = trainer.replay
        if not (finite((rp.queries[:rp.size], rp.values[:rp.size]))
                and rp.num_add == gen_examples):
            failures.append(f"{name}: replay holds non-finite or missing "
                            "rows")
        bel_sums = trainer.episodes.beliefs.sum(-1)
        if not torch.allclose(bel_sums, torch.ones_like(bel_sums),
                              atol=1e-4):
            failures.append(f"{name}: episode beliefs do not sum to one")
        return trainer

    def time_kernel(args, reps: int = 3, dtype=torch.bfloat16, **knobs):
        """``(ms per launch, outputs)`` of the fused solve in ``dtype``."""
        out = grid2p.solve(*args, dtype, **knobs)  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = grid2p.solve(*args, dtype, **knobs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out

    def time_plain(args, **knobs):
        """``(ms, outputs)`` of one run of the plain version in bf16."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = grid2p.solve_reference(*args, torch.bfloat16, **knobs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), ref

    def io_bytes(net) -> int:
        """Bytes one solve of B lanes must move: inputs read once (beliefs,
        bid, player and stop iteration of every lane, the net), outputs
        written once."""
        net_bytes = 0 if net is None else sum(
            p.numel() * (2 if p.dim() == 2 else 4) for p in net.parameters())
        return 4 * B * (2 * H + 3 + 2 * H + H * A + A * H * A) + net_bytes

    def report(kernel, trainer, kernel_ms, plain_ms, err) -> None:
        """Print a kernel's times at the self-play path's shapes beside
        its bound, and keep them for the ``kernels`` line."""
        flops = grid2p.mlp_flops_per_lane_iter(
            game, trainer.cfg.n_hidden, trainer.cfg.n_layers) * B * ITERS
        ops_s = flops / H100_BF16_FLOPS
        bytes_s = io_bytes(trainer.net) / H100_HBM_BYTES_PER_S
        bound_by = "operations" if ops_s >= bytes_s else "bytes"
        bound_ms = max(ops_s, bytes_s) * 1e3
        print(f"kernel {kernel}: {kernel_ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bound_ms:.3f} ms ({bound_by}: {flops:.4e} FLOP "
              f"at bf16 peak, {io_bytes(trainer.net)} B), "
              f"{flops / (kernel_ms / 1e3):.4e} FLOP/s")
        measured[kernel] = dict(max_abs_err=err, ms=kernel_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by)

    def shapes(kernel: str, make_params, trainer, check_1024) -> None:
        """The kernel at its self-play path's shapes (the trained net in
        bf16 at B lanes): held to its plain version over CHECK_ITERS
        iterations on random states and on the walked episodes, then timed
        against it over the path's iterations, with the bound.

        Over CHECK_ITERS iterations the random states hold single values;
        the walked states hold exact ties between two actions' values,
        which f32 rounding breaks one way in one version and the other
        way (or not at all) in the other, so those lanes are counted."""
        ep = trainer.episodes
        gen = torch.Generator(dev).manual_seed(7)

        def main_args(num_iters, states):
            t_stop = torch.randint(0, num_iters + 1, (B,), device=dev,
                                   generator=gen)
            return (game, make_params(num_iters), *states, t_stop,
                    trainer.net)

        args = main_args(CHECK_ITERS, random_inputs(B, CHECK_ITERS, 30)[:3])
        label = f"{kernel} bf16 main shapes: B={B} iters={CHECK_ITERS}"
        check = short_check if kernel == "grid2_cfr" else tie_check
        err = check(label, grid2p.solve(*args, torch.bfloat16),
                    grid2p.solve_reference(*args, torch.bfloat16),
                    TOL_BF16_TRAINED)
        precision_control(label, args, TOL_BF16_TRAINED)

        walked = (ep.root_bid, ep.root_player, ep.beliefs)
        args = main_args(CHECK_ITERS, walked)
        ties = snap_diff(grid2p.solve(*args, torch.bfloat16),
                         grid2p.solve_reference(*args, torch.bfloat16)
                         ) > LANE_TOL
        share = float(ties.float().mean())
        print(f"{kernel} walked episodes: B={B} iters={CHECK_ITERS} "
              f"{int(ties.sum())} lanes with exact value ties (share "
              f"{share:.3e}, limit {TIE_SHARE:.0e}) "
              f"{'ok' if share <= TIE_SHARE else 'MISS'}")
        if share > TIE_SHARE:
            failures.append(f"{kernel} walked episodes: too many lanes "
                            f"differ within {CHECK_ITERS} iterations")
        args = main_args(ITERS, walked)
        kernel_ms, out = time_kernel(args)
        plain_ms, ref = time_plain(args)
        check_1024(args, out, ref, ties)
        report(kernel, trainer, kernel_ms, plain_ms, err)
        # The same launch with an f32 MLP (FMA, the hidden matrix streamed
        # through shared memory), as the in-training evaluation runs it.
        f32_ms, out = time_kernel(args, reps=1, dtype=torch.float32)
        flops = grid2p.mlp_flops_per_lane_iter(
            game, trainer.cfg.n_hidden, trainer.cfg.n_layers) * B * ITERS
        print(f"kernel {kernel} f32: {f32_ms:.3f} ms a launch at the same "
              f"shapes, bound {flops / H100_F32_FLOPS * 1e3:.3f} ms "
              f"({flops:.4e} FLOP at the f32 peak)")
        if not finite(out):
            failures.append(f"{kernel} f32 at the main shapes: non-finite "
                            "outputs")

    def control_1024(args):
        """The plain version on the CPU on the first CONTROL_LANES lanes."""
        n = CONTROL_LANES
        return n, grid2p.solve_reference(
            game, args[1], *[x[:n].cpu() for x in args[2:6]],
            copy.deepcopy(args[6]).cpu(), torch.bfloat16)

    def cfr_check_1024(args, out, ref, ties) -> None:
        """CFR over the path's iterations on the walked episodes: the
        statistics of long_check against a control on the CPU."""
        n, cpu = control_1024(args)
        long_check(f"grid2_cfr bf16 main shapes, walked episodes: B={B} "
                   f"iters={ITERS} (ties left out; control on {n} lanes)",
                   out, ref, grid2p.Grid2Outputs(*(x[:n] for x in ref)), cpu,
                   keys=("rvm_mean", "rvm_max"), keep=~ties,
                   keep_part=~ties[:n])

    def fp_check_1024(args, out, ref, ties) -> None:
        """FP over the path's iterations on the walked episodes: its
        iterates do not drift, so the limits are FP_LONG_LIMIT's floors,
        or FP_LONG_FACTOR times a control on the CPU where that is
        larger."""
        n, cpu = control_1024(args)
        long_check(f"grid2_fp bf16 main shapes, walked episodes: B={B} "
                   f"iters={ITERS} (ties left out; control on {n} lanes)",
                   out, ref, grid2p.Grid2Outputs(*(x[:n] for x in ref)), cpu,
                   keep=~ties, keep_part=~ties[:n], factor=FP_LONG_FACTOR,
                   floor=FP_LONG_LIMIT)

    cfr_trainer = None
    if any(p in phases for p in ("cfr-selfplay", "cfr-shapes",
                                 "knob-checks")):
        cfr_trainer = selfplay("cfr-selfplay", cfr(ITERS), epochs=2)
        lap("cfr-selfplay")
    if "cfr-shapes" in phases:
        shapes("grid2_cfr", cfr, cfr_trainer, cfr_check_1024)
        lap("cfr-shapes")

    # ------------------------------------- 6. evaluation at the protocol
    def exploit_at(reports, repeats):
        return next(r["exploitability"] for r in reports
                    if r["repeats"] == repeats)

    def evaluate(solver: str) -> None:
        cell = EVAL_CELLS[solver]
        sub = (cfr if solver == "cfr" else fp)(ITERS)
        kernel = grid2p.kernel_name(sub)
        value_fn, net = recursive_eval._load_net(str(ROOT / cell["ckpt"]),
                                                 game, "cuda")
        reset_counts()
        grid2p.solve.events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = recursive_eval.run_eval(
            game, sub, value_fn, subgame_iters=ITERS,
            num_repeats=EVAL_REPEATS, mdp_depth=2, dtype=torch.float32,
            net_name=cell["ckpt"], engine="kernel", net=net, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        events, grid2p.solve.events = grid2p.solve.events, None
        kernel_s = sum(s.elapsed_time(e) for _, s, e in events) / 1e3
        print(f"eval {solver}: 1x4f, {cell['ckpt']}, linear "
              f"{solver.upper()} {ITERS} iters x {EVAL_REPEATS} repeats, "
              f"depth-2 subgames, kernel engine, "
              f"{res['net_compute_dtype']} MLP, f32 solve, lane block "
              f"{res['lane_block']}")
        n = read_counts(f"eval {solver}", kernel)
        if n != len(events):
            failures.append(f"eval {solver}: {n} launches, {len(events)} "
                            "timed")
        # The full-tree solve alone, timed apart (run_eval has run the
        # same solve): what is left of the wall time is the recursion's
        # host bookkeeping, transfers and the reports.
        t0 = time.perf_counter()
        full_strategy, _, _ = recursive_eval.full_solve(
            game, sub, torch.float32, progress=False,
            collect_iterates=sub.use_cfr, device="cuda")
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        full_tree = res["exploitability"]["full_tree"]
        reports = res["sampled_reports"]
        print(f"  full_tree: {full_tree:.6f} (JAX package, f32 on a TPU: "
              f"{cell['full_tree']:.6f}); immediate regrets: "
              f"{res['immediate_regrets']}")
        for r in reports:
            print(f"  repeats {r['repeats']:5d}: exploitability "
                  f"{r['exploitability']:.6f} (e0 {r['e0']:.6f}, e1 "
                  f"{r['e1']:.6f}) ev_full {r['ev_full']:.6f}")
        print(f"  {n} launches of {kernel}, kernel {kernel_s:.2f} s (CUDA "
              f"events), wall {wall_s:.2f} s, of which the full-tree "
              f"solve about {full_s:.2f} s (timed apart): host and other "
              f"device work {wall_s - kernel_s - full_s:.2f} s "
              f"({(wall_s - kernel_s - full_s) / wall_s:.1%} of the wall)")
        lo, hi = (x * cell["full_tree"] for x in FULL_TREE_BAND[solver])
        if not lo <= full_tree <= hi:
            failures.append(f"eval {solver}: full_tree {full_tree} outside "
                            f"[{lo}, {hi}]")
        golden = json.loads((ROOT / GOLDEN[solver]).read_text())
        # The fixtures' implementation rounds win probabilities through
        # float32, and FP's ties follow that rounding: so must the context.
        ctx = SolverContext(game=game, tree=unroll_tree(game),
                            dtype=torch.float64, device="cuda",
                            terminal_f32_parity=True)
        solver_g = build_solver(ctx, sub.replace(max_depth=10**6))
        root = RootCtx.concrete(ctx.tree, "cuda")
        state = solver_g.init(root, exploitability.uniform_beliefs(
            game, torch.float64, "cuda"))
        trajectory = []
        for it in range(golden["num_iters"]):
            state = solver_g.step(state, it % 2, root)
            if ((it + 1) & it) == 0:
                trajectory.append(exploitability.compute_exploitability(
                    ctx, solver_g.average_strategy(state, root)))
        worst = max(abs(t - g) - GOLDEN_RTOL * abs(g)
                    for t, g in zip(trajectory, golden["exploitability"]))
        ok = (len(trajectory) == len(golden["exploitability"])
              and worst <= GOLDEN_ATOL)
        print(f"  full tree in f64, {golden['num_iters']} iterations, "
              f"against {GOLDEN[solver]}: exploitability "
              f"{[round(t, 9) for t in trajectory]}, largest excess "
              f"over rtol {worst:.3e} limit {GOLDEN_ATOL:.0e} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"eval {solver}: full-tree trajectory differs "
                            "from the golden fixture")
        # The zero-net control through the same kernels (no MLP).
        reset_counts()
        _, zero_reports = recursive_eval.sampled_eval(
            game, sub, zero_value_fn(game), ZERO_NET_REPEATS, full_strategy,
            dtype=torch.float32, progress=False, engine="kernel",
            device="cuda")
        read_counts(f"eval {solver} zero net", kernel)
        zero = zero_reports[-1]["exploitability"]
        last = reports[-1]["exploitability"]
        at64 = exploit_at(reports, ZERO_NET_REPEATS)
        lo = BAND_LO * min(cell["jax_kernel_bf16"], cell["jax_grid_f32"])
        hi = BAND_HI * max(cell["jax_kernel_bf16"], cell["jax_grid_f32"])
        ok = math.isfinite(last) and last < zero and at64 < zero
        in_band = lo <= last <= hi
        print(f"  zero net at {ZERO_NET_REPEATS} repeats: {zero:.6f}; "
              f"trained net {at64:.6f} at {ZERO_NET_REPEATS}, {last:.6f} "
              f"at {EVAL_REPEATS} {'ok' if ok else 'MISS'}; band "
              f"[{lo:.6f}, {hi:.6f}] around the JAX package's "
              f"{cell['jax_kernel_bf16']:.6f} (kernel, bf16) and "
              f"{cell['jax_grid_f32']:.6f} (grid, f32) "
              f"{'ok' if in_band else 'MISS'}")
        if not ok:
            failures.append(f"eval {solver}: trained net not below the "
                            "zero net")
        if not in_band:
            failures.append(f"eval {solver}: exploitability {last} outside "
                            f"[{lo}, {hi}]")

    if "eval" in phases:
        for solver in EVAL_CELLS:
            evaluate(solver)
            lap(f"eval-{solver}")

    # ---------------------------- 7. the check that does not drift
    def exploit_check(solver: str, g_=None, ckpt=None,
                      repeats=EXPLOIT_REPEATS, plain_chunk=1024,
                      dtype=torch.bfloat16) -> None:
        """A ``repeats``-repeat evaluation over the path's subgame
        iterations through the kernel (MLP operands in ``dtype``, at the
        chosen lane block) and through its plain version (``plain_chunk``
        lanes a solve), held to each other by EXPLOIT_RTOL."""
        g_ = g_ or game
        ckpt = ckpt or EVAL_CELLS[solver]["ckpt"]
        sub = (cfr if solver == "cfr" else fp)(ITERS)
        value_fn, net = recursive_eval._load_net(str(ROOT / ckpt), g_,
                                                 "cuda")
        got = {}
        for name, cls, chunk in (
                ("kernel", recursive.Grid2FrontierSolver, 1024),
                ("plain", recursive.ReferenceFrontierSolver, plain_chunk)):
            fsolver = cls(g_, sub, torch.float32, None, chunk=chunk,
                          engine="kernel", net=net,
                          net_compute_dtype=dtype, device="cuda")
            t0 = time.perf_counter()
            _, reports = recursive_eval.sampled_eval(
                g_, sub, value_fn, repeats, None,
                dtype=torch.float32, progress=False, device="cuda",
                fsolver=fsolver)
            got[name] = reports[-1]
            print(f"  {name}: lane block {fsolver.lane_block_used}, "
                  f"{time.perf_counter() - t0:.2f} s")
        k, p = got["kernel"], got["plain"]
        rel = abs(k["exploitability"] - p["exploitability"]) / p[
            "exploitability"]
        ok = math.isfinite(rel) and rel <= EXPLOIT_RTOL[solver]
        print(f"check exploitability {solver} {g_.num_dice}x{g_.num_faces}"
              f": {repeats} repeats x {ITERS} iters, "
              f"{'bf16' if dtype == torch.bfloat16 else 'f32'}: kernel "
              f"{k['exploitability']:.6f} "
              f"(e0 {k['e0']:.6f}, e1 {k['e1']:.6f}), plain on the card "
              f"{p['exploitability']:.6f} (e0 {p['e0']:.6f}, e1 "
              f"{p['e1']:.6f}), relative diff {rel:.3e} limit "
              f"{EXPLOIT_RTOL[solver]:.1e} {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append(f"exploitability check {solver} "
                            f"{g_.num_dice}x{g_.num_faces} "
                            f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")

    if "exploit-check" in phases:
        for solver in EVAL_CELLS:
            exploit_check(solver)
        lap("exploit-check")

    # -------------------------------------- 8. FP self-play and shapes
    if "fp-selfplay" in phases:
        fp_trainer = selfplay("fp-selfplay", fp(ITERS), epochs=1)
        shapes("grid2_fp", fp, fp_trainer, fp_check_1024)
        lap("fp-selfplay")

    # ------------------------------------------- 9. the kernel's options
    def knob_checks(trainer) -> None:
        f32, bf16 = torch.float32, torch.bfloat16
        # gelu, ablate, operand type: every gelu with both operand types;
        # every ablate in f32 under gelu="exact" (where "cheaperf" must win
        # and change the result) and in bf16 as the benchmark runs it.
        combos = [(g, "", dt) for g in grid2p.GELUS for dt in (f32, bf16)]
        combos += [(g, a, dt) for a in grid2p.ABLATIONS[1:]
                   for g, dt in (("exact", f32), ("auto", bf16))]
        for k, (gelu, ablate, dtype) in enumerate(combos):
            for use_ln in (True, False):
                net, net_dev = fresh_net(2, use_ln, 70 + k)
                tol = TOL_BF16 if dtype == bf16 else TOL_F32
                knobs = dict(gelu=gelu, ablate=ablate)
                for iters in (CHECK_ITERS, LONG_ITERS):
                    inputs = random_inputs(256, iters, 80 + k)
                    args = (game, cfr(iters), *inputs, net_dev, dtype)
                    out = grid2p.solve(*args, **knobs)
                    ref = grid2p.solve_reference(*args, **knobs)
                    label = (f"knobs gelu={gelu} ablate={ablate or '-'} "
                             f"{'bf16' if dtype == bf16 else 'f32'} "
                             f"{'ln' if use_ln else 'noln-net'}: B=256 "
                             f"iters={iters}")
                    if iters == CHECK_ITERS:
                        short_check(label, out, ref, tol)
                    else:
                        most_lanes_check(label, out, ref, MOST_LANES_TOL[
                            "bf16" if dtype == bf16 else "f32"])
        # "cheaperf" wins over gelu="exact": in f32 the kernel with both
        # must land on the plain version with the fast GELU, several times
        # closer than on the plain version with the exact one.
        net, net_dev = fresh_net(2, True, 99)
        args = (game, cfr(CHECK_ITERS), *random_inputs(256, CHECK_ITERS, 98),
                net_dev, f32)
        out = grid2p.solve(*args, gelu="exact", ablate="cheaperf")
        to_fast = max_diff(out, grid2p.solve_reference(*args, gelu="fast"))
        to_exact = max_diff(out, grid2p.solve_reference(*args, gelu="exact"))
        ok = PRECEDENCE_FACTOR * to_fast < to_exact
        print(f"control knobs cheaperf with gelu=exact in f32: max_abs_diff "
              f"to the plain fast GELU {to_fast:.3e}, to the plain exact "
              f"GELU {to_exact:.3e}, must be {PRECEDENCE_FACTOR}x apart "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            failures.append("cheaperf does not win over gelu=exact")
        lap("knob-checks: options against the plain version")

        # Every mlp_chunks and interleave=2 against the default, bit for
        # bit, on the walked episodes with the trained net.
        ep = trainer.episodes
        walked = (ep.root_bid, ep.root_player, ep.beliefs)
        gen = torch.Generator(dev).manual_seed(11)

        def same_bits(label, out, base, lanes=B) -> None:
            ok = finite(out) and all(torch.equal(x, y[:lanes])
                                     for x, y in zip(out, base))
            diff = max_diff(out, [y[:lanes] for y in base])
            print(f"check {label}: bit-identical to the default "
                  f"(max_abs_diff={diff:.3e}) {'ok' if ok else 'MISS'}")
            if not ok:
                failures.append(f"kernel check {label}")

        for iters in (LONG_ITERS, ITERS):
            t_stop = torch.randint(0, iters + 1, (B,), device=dev,
                                   generator=gen)
            args = (game, cfr(iters), *walked, t_stop, trainer.net)
            for dtype in (f32, bf16):
                name = "bf16" if dtype == bf16 else "f32"
                base = grid2p.solve(*args, dtype)
                for lane_block, values in KNOB_CHUNKS.items():
                    lanes = B if lane_block == 8 else 256
                    part = (*args[:2], *(x[:lanes] for x in args[2:6]),
                            args[6])
                    for chunks in values:
                        same_bits(
                            f"knobs mlp_chunks={chunks} lane_block="
                            f"{lane_block} {name}: B={lanes} iters={iters}",
                            grid2p.solve(*part, dtype, lane_block=lane_block,
                                         mlp_chunks=chunks), base, lanes)
                same_bits(f"knobs interleave=2 {name}: B={B} iters={iters}",
                          grid2p.solve(*args, dtype, interleave=2), base)
                same_bits(f"knobs interleave=2 mlp_chunks=4 {name}: B={B} "
                          f"iters={iters}",
                          grid2p.solve(*args, dtype, interleave=2,
                                       mlp_chunks=4), base)
        main_args = args  # the walked episodes over the path's iterations
        lap("knob-checks: bit-identity")

        # grid2_cfr_il2 at the self-play path's shapes: against its plain
        # version over CHECK_ITERS iterations, then timed.  Over 1024
        # iterations it gives grid2_cfr's bits (above), and grid2_cfr is
        # held by phase 5.
        t_stop = torch.randint(0, CHECK_ITERS + 1, (B,), device=dev,
                               generator=gen)
        args = (game, cfr(CHECK_ITERS), *random_inputs(B, CHECK_ITERS, 31)[:3],
                t_stop, trainer.net)
        err = short_check(
            f"grid2_cfr_il2 bf16 main shapes: B={B} iters={CHECK_ITERS}",
            grid2p.solve(*args, bf16, interleave=2),
            grid2p.solve_reference(*args, bf16, lane_block=8, interleave=2),
            TOL_BF16_TRAINED)

        # Which layouts fit a block's shared memory: every mlp_chunks at
        # lane_block 8 in both operand types (neither stages a group of
        # pairs, so all fit), and the lane blocks and depths that bf16's
        # weights and f32's rows and ring leave room for.  A layout that
        # does not fit must raise before anything launches.
        def fits(label, *a, **knobs) -> str:
            before = grid2p.solve.launches
            try:
                grid2p.solve(*a, **knobs)
                return "fits"
            except ValueError as e:
                if grid2p.solve.launches != before:
                    failures.append(f"{label}: launched, then raised")
                return str(e)

        print(f"layouts at 1x4f (a block may use {grid2p.SMEM_LIMIT} B of "
              f"shared memory):")
        for dtype, name in ((f32, "f32"), (bf16, "bf16")):
            told = {}
            for knobs in [dict(mlp_chunks=c) for c in range(1, 29)] + [
                    dict(mlp_chunks=c, interleave=2) for c in (2, 3, 4, 7)]:
                got = fits(f"{name} {knobs}", *args, dtype, lane_block=8,
                           **knobs)
                told.setdefault(got, []).append(knobs)
                if got != "fits":
                    failures.append(f"{name} {knobs} at lane_block 8: {got}")
            for got, knobs in told.items():
                print(f"  {name} lane_block 8, {len(knobs)} settings "
                      f"({knobs[0]} .. {knobs[-1]}): {got}")
        net3, net3_dev = fresh_net(3, True, 97)
        part = [x[:1020] for x in args[2:6]]  # a multiple of 12 lanes
        for label, a, knobs, want in (
                ("bf16 cfr lane_block 12", (game, args[1], *part, args[6]),
                 dict(lane_block=12), True),
                ("bf16 fp lane_block 12", (game, fp(CHECK_ITERS), *part,
                                           args[6]), dict(lane_block=12),
                 False),
                ("bf16 cfr 3 hidden layers", (*args[:6], net3_dev),
                 dict(lane_block=8), False),
                ("f32 cfr lane_block 16", args, dict(lane_block=16), True),
                ("f32 fp lane_block 24", (game, fp(CHECK_ITERS), *(
                    x[:1008] for x in args[2:6]), args[6]),
                 dict(lane_block=24), False)):
            dtype = f32 if label.startswith("f32") else bf16
            got = fits(label, *a, dtype, **knobs)
            print(f"  {label}: {got}")
            if (got == "fits") != want:
                failures.append(f"{label}: {got}")

        args = main_args
        il1_ms, _ = time_kernel(args)
        il2_ms, _ = time_kernel(args, interleave=2)
        il2_again, _ = time_kernel(args, interleave=2)
        il1_again, _ = time_kernel(args)
        print(f"grid2_cfr {il1_ms:.3f} and {il1_again:.3f} ms, "
              f"grid2_cfr_il2 {il2_ms:.3f} and {il2_again:.3f} ms at B={B}, "
              f"{ITERS} iterations, bf16 (in turns: 1, 2, 2, 1)")
        plain_ms, _ = time_plain(args, lane_block=8, interleave=2)
        report("grid2_cfr_il2", trainer, min(il2_ms, il2_again), plain_ms,
               err)

    if "knob-checks" in phases:
        knob_checks(cfr_trainer)
        lap("knob-checks: grid2_cfr_il2 at the main shapes")

    # ---------------------------------------- 10. the generation benchmark
    if "bench" in phases:
        from rebel_tpu_torch import bench

        reset_counts()
        runs = [[],
                ["--interleave", "2", "--headline-only"]]
        runs += [["--ablate", a, "--headline-only", "--steps", "2"]
                 for a in grid2p.ABLATIONS[1:]]
        lines = []
        for argv in runs:
            print(f"bench {' '.join(argv) or '(defaults)'}:")
            lines += bench.main(["--deadline", "0", *argv])
        read_counts("bench", *KERNELS)
        for line in lines:
            d = line.get("detail", {})
            if "error" in line or not math.isfinite(line.get("value") or
                                                    math.nan):
                failures.append(f"bench: bad line {line}")
            elif not math.isfinite(d.get("checksum", math.nan)):
                failures.append(f"bench: non-finite checksum in {line}")
        full = lines[1]["detail"]
        nonet_ms = (full["no_net_cfr_kernel_s"] * 1e3
                    / sum(full["no_net_cfr_launches"].values()))
        lanes = full["batch"]
        nonet_bytes = 4 * lanes * (2 * H + 3 + 2 * H + H * A + A * H * A)
        nonet_ops = (grid2p.nonet_ops_per_lane_iter(game, True) * lanes
                     * full["num_iters"])
        bytes_ms = nonet_bytes / H100_HBM_BYTES_PER_S * 1e3
        ops_ms = nonet_ops / H100_F32_FLOPS * 1e3
        print(f"bench no-net: kernel {nonet_ms:.3f} ms per launch of {lanes} "
              f"lanes; bound {max(bytes_ms, ops_ms):.6f} ms (bytes: "
              f"{nonet_bytes} B at {H100_HBM_BYTES_PER_S:.3e} B/s, "
              f"{bytes_ms:.6f} ms; operations: {nonet_ops:.4e} f32 at "
              f"{H100_F32_FLOPS:.2e}/s, {ops_ms:.6f} ms; share "
              f"{max(bytes_ms, ops_ms) / nonet_ms:.4%}); no-net share of a "
              f"CFR solve "
              f"{nonet_ms / (full['kernel_s'] * 1e3 / full['steps']):.4f}")
        lap("bench")

    # --------------------------------------------------- 11. the run entry
    def training_state_diffs(a, b) -> dict:
        """Per part of two trainers' state (the net's parameters and
        buffers, the optimizer's state and settings, the replay ring's rows
        and counters): 0.0 where the two are equal (``torch.equal``), else
        the largest absolute difference (inf where shapes or settings
        differ)."""
        def diff(x, y) -> float:
            if torch.is_tensor(x):
                # Adam keeps its step count on the host or on the card by
                # how the state was made; the values are what counts.
                x, y = x.cpu(), y.cpu()
                if x.shape != y.shape:
                    return math.inf
                if torch.equal(x, y):
                    return 0.0
                return float((x.double() - y.double()).abs().max())
            return 0.0 if repr(x) == repr(y) else math.inf

        out = {}
        for k, x in a.net.state_dict().items():
            out[f"net.{k}"] = diff(x, b.net.state_dict()[k])
        sa, sb = a.opt.state_dict(), b.opt.state_dict()
        out["optimizer.param_groups"] = diff(sa["param_groups"],
                                             sb["param_groups"])
        for i, st in sa["state"].items():
            for k, x in st.items():
                out[f"optimizer.state.{i}.{k}"] = diff(x, sb["state"][i][k])
        for k in ("queries", "values", "priorities", "head", "size",
                  "num_add"):
            out[f"replay.{k}"] = diff(getattr(a.replay, k),
                                      getattr(b.replay, k))
        return out

    def run_entry() -> None:
        """``python -m rebel_tpu_torch.run`` in process, as users train:
        two epochs from a fresh experiment dir (an exploit evaluation at
        epoch 0), then ``--mode start_continue`` to a third (one at epoch
        2); checks the files, the metrics, the checkpoints and their
        ``.params`` exports, the resume and the kernels' launches."""
        import tempfile

        from rebel_tpu_torch import run as run_mod
        from rebel_tpu_torch.nets import convert

        rows = 2 * B  # examples a generation step adds
        with tempfile.TemporaryDirectory() as tmp:
            exp = pathlib.Path(tmp) / "liars_sp"
            outs = []
            for mode, epochs in (("gentle_start", 2), ("start_continue", 3)):
                reset_counts()
                t0 = time.perf_counter()
                out = run_mod.execute([
                    "--cfg", str(ROOT / "conf" / "liars_sp.yaml"), "--exp_dir",
                    str(exp), "--mode", mode, *RUN_ENTRY_ARGS,
                    f"max_epochs={epochs}"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tr = out.trainer
                gen = tr.gen_steps - (outs[-1].trainer.gen_steps
                                      if outs else 0)
                print(f"run-entry --mode {mode} max_epochs={epochs}: "
                      f"{wall:.2f} s wall, epochs {tr.epoch}, {gen} "
                      f"generation steps, burn-in {tr.burn_in_s:.3f} s")
                total = read_counts(f"run-entry {mode}", "grid2_cfr")
                if total - gen <= 0:
                    failures.append(f"run-entry {mode}: grid2_cfr launched "
                                    f"{total} times for {gen} generation "
                                    "steps: none in the evaluation")
                print(f"  grid2_cfr launches: {gen} in generation (bf16), "
                      f"{total - gen} in the exploit evaluation (f32); lane "
                      f"block of the last launch "
                      f"{grid2p.solve.last_lane_block}")
                outs.append(out)
            lines = [json.loads(x) for x in
                     (exp / "metrics.jsonl").read_text().splitlines()]
            for m in lines:
                # timing/gen and timing/train are means over the epochs run
                # in the process: epochs 0-1 in the first, 2 in the second.
                n = m["epoch"] + 1 if m["epoch"] < 2 else m["epoch"] - 1
                parts = {k: m[k] for k in m
                         if k.startswith(("timing/exploit", "exploitability"))
                         or k in ("timing/checkpoint", "checkpoint/bytes")}
                print(f"  epoch {m['epoch']}: generation "
                      f"{m['timing/gen'] * n:.3f} s and training "
                      f"{m['timing/train'] * n:.3f} s over the {n} "
                      f"epoch(s) of its process, loss {m['loss/train']:.6f}, "
                      f"buffer/added {m['buffer/added']}; "
                      + ", ".join(f"{k} {v:.4g}" for k, v in parts.items()))
            missing = [k for k in EPOCH_METRICS + ("loss/valid_snapshot_0000",)
                       if k not in lines[0]] + [
                k for k in EXPLOIT_METRICS
                if k not in lines[0] or k not in lines[2]]
            if missing:
                failures.append(f"run-entry: metrics missing: {missing}")
            for m in (lines[0], lines[2]):
                for k in ("exploitability_last", "exploitability_avg"):
                    if not (0 <= m.get(k, math.nan) <= 2):
                        failures.append(f"run-entry epoch {m['epoch']}: {k} "
                                        f"{m.get(k)}")
            files = ["result.json", "config.json", "heartbeat",
                     "metrics.jsonl"] + [f"ckpt/epoch{e}.{x}" for e in range(3)
                                         for x in ("ckpt", "params")]
            absent = [f for f in files if not (exp / f).exists()]
            if absent:
                failures.append(f"run-entry: files missing: {absent}")
            resumed = outs[1].trainer
            gen2 = resumed.gen_steps - outs[0].trainer.gen_steps
            if [m["epoch"] for m in lines] != [0, 1, 2] or (
                    lines[2]["buffer/added"]
                    != lines[1]["buffer/added"] + rows * gen2):
                failures.append(
                    "run-entry: the resumed run did not continue epoch 2 "
                    f"from the checkpoint ({[m['epoch'] for m in lines]}, "
                    f"buffer/added {[m['buffer/added'] for m in lines]}, "
                    f"{gen2} steps of {rows} rows)")
            q = torch.rand((1024, game.query_size),
                           generator=torch.Generator().manual_seed(5)).to(dev)
            exported = convert.load_params_net(exp / "ckpt" / "epoch2.params",
                                               game, dev)
            with torch.no_grad():
                same = torch.equal(exported(q), resumed.net(q))
            print(f"  epoch2.params against the live net on 1024 queries: "
                  f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                failures.append("run-entry: epoch2.params differs from the "
                                "live net")
            if not all(math.isfinite(x) for x in (
                    lines[0]["loss/train"], lines[2]["loss/train"])):
                failures.append("run-entry: non-finite training loss")

            # The resume against a straight run: three epochs from a fresh
            # dir in one process (no exploit evaluation, which changes no
            # training state) must leave the state the resumed third epoch
            # left, bit for bit.
            t0 = time.perf_counter()
            reset_counts()
            straight = run_mod.execute([
                "--cfg", str(ROOT / "conf" / "liars_sp.yaml"), "--exp_dir",
                str(pathlib.Path(tmp) / "straight"), "--mode", "gentle_start",
                *RUN_ENTRY_ARGS, "max_epochs=3", "exploit=false"]).trainer
            torch.cuda.synchronize()
            read_counts("run-entry straight", "grid2_cfr")
            diffs = training_state_diffs(resumed, straight)
            differ = {k: v for k, v in diffs.items() if v != 0.0}
            print(f"  resumed epoch 2 against a straight run of 3 epochs: "
                  f"{len(diffs) - len(differ)} of {len(diffs)} parts of the "
                  f"state (net, optimizer, replay ring) bit-identical"
                  f"{'' if not differ else ', differing: ' + str(differ)} "
                  f"{'ok' if not differ else 'MISS'}; "
                  f"{time.perf_counter() - t0:.2f} s added")
            if differ:
                failures.append(f"run-entry: the resumed run's state differs "
                                f"from a straight run's: {sorted(differ)}")

    if "run-entry" in phases:
        run_entry()
        lap("run-entry")

    # ----------------------------------------------- 12. the larger games
    def games() -> None:
        """Per game, solver and operand type, with the game's trained net:
        the lane block the wrapper chooses and its shared memory; the
        kernel against its plain version over CHECK_ITERS iterations (the
        absolute limits of the 1x4f checks) and over LONG_ITERS (the
        statistics against a plain(card)-vs-plain(cpu) control); one
        launch of B lanes over the path's iterations, timed, beside the
        bound of the game's MLP FLOP."""
        n = GAME_CONTROL_LANES
        for k, ((nd, nf), nets) in enumerate(GAME_NETS.items()):
            g_ = LiarsDice(nd, nf)
            for solver, ckpt in nets.items():
                make = cfr if solver == "cfr" else fp
                net = recursive_eval._load_net(str(ROOT / ckpt), g_,
                                               "cuda")[1]
                net_cpu = copy.deepcopy(net).cpu()
                kernel = grid2p.kernel_name(make(ITERS))
                for dtype in (torch.bfloat16, torch.float32):
                    bf16 = dtype == torch.bfloat16
                    name = f"{nd}x{nf} {solver} {'bf16' if bf16 else 'f32'}"
                    lb = grid2p.choose_lane_block(g_, make(ITERS), net, dtype,
                                                  B)
                    plan = grid2p.kernel_plan(g_, make(ITERS), net, dtype, B,
                                              lb)
                    print(f"games {name} ({ckpt}): {kernel}, lane block {lb}"
                          f", shared memory {plan.smem} B, mlp_chunks "
                          f"{plan.mlp_chunks}")
                    tol = (TOL_BF16_TRAINED if bf16 else
                           TOL_F32 if solver == "cfr" else TOL_FP_F32)
                    for iters in (CHECK_ITERS, LONG_ITERS):
                        inputs = random_inputs(GAME_LANES, iters, 60 + k, g_)
                        args = (g_, make(iters), *inputs, net)
                        out = grid2p.solve(*args, dtype)
                        if grid2p.solve.last_lane_block != lb:
                            failures.append(
                                f"games {name}: launched at lane block "
                                f"{grid2p.solve.last_lane_block}, chosen {lb}")
                        ref = grid2p.solve_reference(*args, dtype)
                        label = (f"games {name}: B={GAME_LANES} "
                                 f"iters={iters}")
                        if solver == "fp":
                            tie_check(label, out, ref, tol)
                        if iters == CHECK_ITERS:
                            if solver == "cfr":
                                short_check(label, out, ref, tol)
                            if bf16:
                                precision_control(label, args, tol)
                            continue
                        cpu = grid2p.solve_reference(
                            g_, make(iters), *[x[:n].cpu() for x in inputs],
                            net_cpu, dtype)
                        long_check(f"{label} (control on {n} lanes)", out,
                                   ref, grid2p.Grid2Outputs(
                                       *(x[:n] for x in ref)), cpu,
                                   flips=FP_TIE_SHARE if solver == "fp"
                                   else None)
                    args = (g_, make(ITERS), *random_inputs(B, ITERS, 70, g_),
                            net)
                    ms, out = time_kernel(args, reps=1, dtype=dtype)
                    flops = grid2p.mlp_flops_per_lane_iter(g_, 256, 2) \
                        * B * ITERS
                    bound_ms = flops / (H100_BF16_FLOPS if bf16
                                        else H100_F32_FLOPS) * 1e3
                    print(f"  {kernel} {name}: {ms:.3f} ms a launch of {B} "
                          f"lanes x {ITERS} iterations at lane block {lb}; "
                          f"bound {bound_ms:.3f} ms ({flops:.4e} model FLOP "
                          f"at the {'bf16' if bf16 else 'f32'} peak, share "
                          f"{bound_ms / ms:.2%})")
                    if not finite(out):
                        failures.append(f"games {name}: non-finite outputs "
                                        f"at B={B}")

    def lane_block_bits() -> None:
        """LANE_BLOCK_PAIRS: the same lanes at two lane blocks, over the
        path's iterations, bit for bit."""
        for (nd, nf), solver, dname, blocks in LANE_BLOCK_PAIRS:
            g_ = LiarsDice(nd, nf)
            net = recursive_eval._load_net(
                str(ROOT / GAME_NETS[nd, nf][solver]), g_, "cuda")[1]
            dtype = torch.bfloat16 if dname == "bf16" else torch.float32
            args = (g_, (cfr if solver == "cfr" else fp)(ITERS),
                    *random_inputs(GAME_LANES, ITERS, 90, g_), net, dtype)
            a, b = (grid2p.solve(*args, lane_block=lb) for lb in blocks)
            ok = finite(a) and all(torch.equal(x, y) for x, y in zip(a, b))
            print(f"check games {nd}x{nf} {solver} {dname}: B={GAME_LANES} "
                  f"iters={ITERS}, lane block {blocks[0]} against "
                  f"{blocks[1]}: bit-identical (max_abs_diff="
                  f"{max_diff(a, b):.3e}) {'ok' if ok else 'MISS'}")
            if not ok:
                failures.append(f"games {nd}x{nf} {solver} {dname}: lane "
                                f"blocks {blocks} differ")

    if "games" in phases:
        games()
        lane_block_bits()
        lap("games")

    # ----------------------------------------- 13. 2x3f over 1024 iterations
    def games_1024(solver: str, ckpt: str) -> None:
        """At 2x3f in bf16, at the chosen lane block, over the path's
        iterations: the kernel against its plain version on the card by
        the statistics of the 1x4f path checks, against a
        plain(card)-vs-plain(cpu) control on GAMES_1024_CONTROL_LANES
        lanes (FP: its floors and flip lanes)."""
        g23 = LiarsDice(2, 3)
        make = cfr if solver == "cfr" else fp
        net = recursive_eval._load_net(str(ROOT / ckpt), g23, "cuda")[1]
        inputs = random_inputs(GAME_LANES, ITERS, 80, g23)
        args = (g23, make(ITERS), *inputs, net)
        out = grid2p.solve(*args, torch.bfloat16)
        lb = grid2p.solve.last_lane_block
        ref = grid2p.solve_reference(*args, torch.bfloat16)
        n = GAMES_1024_CONTROL_LANES
        cpu = grid2p.solve_reference(
            g23, make(ITERS), *[x[:n].cpu() for x in inputs],
            copy.deepcopy(net).cpu(), torch.bfloat16)
        label = (f"games 2x3 {solver} bf16: B={GAME_LANES} iters={ITERS} "
                 f"lane block {lb} (control on {n} lanes)")
        part = grid2p.Grid2Outputs(*(x[:n] for x in ref))
        if solver == "cfr":
            long_check(label, out, ref, part, cpu,
                       keys=("rvm_mean", "rvm_max"))
        else:
            long_check(label, out, ref, part, cpu, factor=FP_LONG_FACTOR,
                       floor=FP_LONG_LIMIT, flips=FP_TIE_SHARE)

    if "games-exploit" in phases:
        g23 = LiarsDice(2, 3)
        for solver, ckpt in GAME_NETS[2, 3].items():
            games_1024(solver, ckpt)
        exploit_check("fp", g23, GAME_NETS[2, 3]["fp"], GAMES_EXPLOIT_REPEATS,
                      plain_chunk=GAMES_PLAIN_CHUNK, dtype=torch.float32)
        lap("games-exploit")

    # --------------------------------------------- 14. the run entry at 2x3
    def run_entry_2x3() -> None:
        """``python -m rebel_tpu_torch.run`` in process at 2x3 with the
        round-5 overrides: burn-in and one epoch through the fused solve at
        the chosen lane block, and its checkpoint."""
        import tempfile

        from rebel_tpu_torch import run as run_mod

        with tempfile.TemporaryDirectory() as tmp:
            exp = pathlib.Path(tmp) / "liars_sp_2x3"
            reset_counts()
            t0 = time.perf_counter()
            out = run_mod.execute([
                "--cfg", str(ROOT / "conf" / "liars_sp.yaml"), "--exp_dir",
                str(exp), "--mode", "gentle_start", *RUN_ENTRY_2X3_ARGS])
            torch.cuda.synchronize()
            tr = out.trainer
            kernel = grid2p.kernel_name(tr.cfg.env.subgame_params)
            print(f"run-entry-2x3: {time.perf_counter() - t0:.2f} s wall, "
                  f"epochs {tr.epoch}, {tr.gen_steps} generation steps "
                  f"(burn-in {tr.burn_in_s:.3f} s) through {kernel} at lane "
                  f"block {grid2p.solve.last_lane_block}")
            read_counts("run-entry-2x3", kernel, expect=tr.gen_steps)
            m = json.loads((exp / "metrics.jsonl").read_text().splitlines()[0])
            print(f"  epoch 0: generation {m['timing/gen']:.3f} s, training "
                  f"{m['timing/train']:.3f} s, loss {m['loss/train']:.6f}, "
                  f"checkpoint {m.get('timing/checkpoint', math.nan):.3f} s, "
                  f"{m.get('checkpoint/bytes')} B")
            absent = [f for f in ("ckpt/epoch0.ckpt", "ckpt/epoch0.params",
                                  "result.json")
                      if not (exp / f).exists()]
            if absent or not math.isfinite(m["loss/train"]):
                failures.append(f"run-entry-2x3: files missing {absent} or "
                                f"loss {m['loss/train']}")

    if "run-entry-2x3" in phases:
        run_entry_2x3()
        lap("run-entry-2x3")

    # ------------------------------------------- 15. the fast engine, f32
    def fast_check() -> None:
        """The ``fast`` frontier engine (plain PyTorch, f32, the JAX
        package's default) against the kernel with an f32 MLP: a
        EXPLOIT_REPEATS-repeat evaluation of each 1x4f net over
        FAST_CHECK_ITERS subgame iterations, held by EXPLOIT_RTOL; then
        the benchmark's ``batch_first`` layout (the ``fast`` self-play
        engine) for 2 steps."""
        f32 = torch.float32
        for solver, cell in EVAL_CELLS.items():
            sub = (cfr if solver == "cfr" else fp)(FAST_CHECK_ITERS[solver])
            value_fn, net = recursive_eval._load_net(str(ROOT / cell["ckpt"]),
                                                     game, "cuda")
            got = {}
            for name, fsolver in (
                    ("fast", recursive.Grid2FrontierSolver(
                        game, sub, f32, value_fn, engine="fast",
                        device="cuda")),
                    ("kernel f32", recursive.Grid2FrontierSolver(
                        game, sub, f32, None, engine="kernel", net=net,
                        net_compute_dtype=f32, device="cuda"))):
                t0 = time.perf_counter()
                _, reports = recursive_eval.sampled_eval(
                    game, sub, value_fn, EXPLOIT_REPEATS, None, dtype=f32,
                    progress=False, device="cuda", fsolver=fsolver)
                got[name] = reports[-1]["exploitability"]
                print(f"  {name}: {got[name]:.6f}, "
                      f"{time.perf_counter() - t0:.2f} s")
            rel = abs(got["fast"] - got["kernel f32"]) / got["kernel f32"]
            ok = math.isfinite(rel) and rel <= EXPLOIT_RTOL[solver]
            print(f"check fast engine {solver}: {EXPLOIT_REPEATS} repeats x "
                  f"{sub.num_iters} iters, f32: fast {got['fast']:.6f}, kernel "
                  f"{got['kernel f32']:.6f}, relative diff {rel:.3e} limit "
                  f"{EXPLOIT_RTOL[solver]:.1e} {'ok' if ok else 'MISS'}")
            if not ok:
                failures.append(f"fast engine check {solver}")
        from rebel_tpu_torch import bench

        reset_counts()
        print("bench --layout batch_first --steps 2 --headline-only:")
        (line,) = bench.main(["--deadline", "0", "--layout", "batch_first",
                              "--steps", "2", "--headline-only"])
        if not (math.isfinite(line["value"])
                and math.isfinite(line["detail"]["checksum"])):
            failures.append(f"bench batch_first: bad line {line}")
        if grid2p.solve.launches:
            failures.append("bench batch_first launched the kernel")

    if "fast-check" in phases:
        fast_check()
        lap("fast-check")

    # ---------------------------------------------------- 16. the SPMD path
    def spmd_world1(tmp: pathlib.Path) -> None:
        """(a) run_spmd at world size 1 over NCCL: two epochs, then a
        resume to a third, against a straight run of three."""
        import torch.distributed as dist

        from rebel_tpu_torch import config as cfglib
        from rebel_tpu_torch.parallel.launcher import _free_port

        cfg = cfglib.apply_overrides(
            cfglib.load_yaml_config(ROOT / "conf" / "liars_sp.yaml"),
            SPMD_ARGS)
        cfg.pop("launcher", None)
        tcfg = cfglib.cfg_to_trainer_config(cfg)
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{_free_port()}", world_size=1, rank=0)
        try:
            reset_counts()
            runs = {}
            for name, out, epochs in (("first", "a", 2), ("resumed", "a", 3),
                                      ("straight", "b", 3)):
                t0 = time.perf_counter()
                tr = Trainer(tcfg, device=dev, out_dir=tmp / out)
                state, metrics = tr.run_spmd(max_epochs=epochs)
                torch.cuda.synchronize()
                print(f"spmd world 1 ({dist.get_backend()}) {name}: "
                      f"{time.perf_counter() - t0:.2f} s wall to epoch "
                      f"{epochs}, burn-in {tr.burn_in_s:.3f} s; "
                      + "; ".join(
                          f"epoch {m['epoch']}: generation "
                          f"{m['timing/gen']:.3f} s, training "
                          f"{m['timing/train']:.3f} s, checkpoint "
                          f"{m['timing/checkpoint']:.3f} s "
                          f"({m['checkpoint/bytes']} B), loss "
                          f"{m['loss/train']:.6f}" for m in metrics))
                runs[name] = (tr, state, metrics)
            read_counts("spmd world 1", "grid2_cfr")
        finally:
            dist.destroy_process_group()
        (a, sa, _), (b, sb, _) = runs["resumed"], runs["straight"]
        diffs = training_state_diffs(a, b)
        for k, x in sa.episodes._asdict().items():
            diffs[f"episodes.{k}"] = float(not torch.equal(
                x, getattr(sb.episodes, k)))
        diffs["generator"] = float(not torch.equal(sa.gen.get_state(),
                                                   sb.gen.get_state()))
        differ = {k: v for k, v in diffs.items() if v != 0.0}
        print(f"check spmd world 1: resumed epoch 2 against a straight run "
              f"of 3 epochs: {len(diffs) - len(differ)} of {len(diffs)} "
              "parts (net, optimizer, ring, episodes, generator) "
              f"bit-identical{'' if not differ else ', differing: '}"
              f"{differ or ''} {'ok' if not differ else 'MISS'}")
        if differ:
            failures.append(f"spmd world 1: the resumed state differs from "
                            f"a straight run's: {sorted(differ)}")

    def spmd_two_ranks(tmp: pathlib.Path) -> None:
        """(b) Two ranks on the one card through the run entry."""
        exp = tmp / "two"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rebel_tpu_torch.run", "--cfg",
             str(ROOT / "conf" / "liars_sp.yaml"), "--exp_dir", str(exp),
             *SPMD_RUN_ARGS], cwd=ROOT, capture_output=True, text=True,
            timeout=SPMD_TIMEOUT)
        wall = time.perf_counter() - t0
        bad = []
        if proc.returncode != 0:
            bad.append(f"rc {proc.returncode}: "
                       f"{(proc.stdout + proc.stderr)[-3000:]}")
        result = (json.loads((exp / "result.json").read_text())
                  if (exp / "result.json").exists() else {})
        if result.get("processes") != 2 or result.get("backend") != "gloo":
            bad.append("result.json " + str({
                k: result.get(k) for k in ("processes", "devices",
                                           "backend")}))
        if not (exp / "log.rank1.txt").exists() \
                or (exp / "jobs.json").exists():
            bad.append("log.rank1.txt missing or jobs.json left")
        lines = ([json.loads(x) for x in
                  (exp / "metrics.jsonl").read_text().splitlines()]
                 if (exp / "metrics.jsonl").exists() else [])
        for m in lines:
            ckpt = (f"{m['timing/checkpoint']:.3f} s" if "timing/checkpoint"
                    in m else "none")
            print(f"  spmd two ranks epoch {m['epoch']}: generation "
                  f"{m['timing/gen']:.3f} s, training {m['timing/train']:.3f}"
                  f" s, exploit evaluation {m.get('timing/exploit', 0):.2f} s"
                  f" (recursion {m.get('timing/exploit_recursion', 0):.2f} s"
                  f"), checkpoint {ckpt}, exploitability last "
                  f"{m.get('exploitability_last')} avg "
                  f"{m.get('exploitability_avg')}, loss "
                  f"{m.get('loss/train')}")
        if not lines or not all(0 <= lines[0].get(k, math.nan) <= 2 for k in
                                ("exploitability_last",
                                 "exploitability_avg")):
            bad.append("no exploitability in [0, 2] at epoch 0")
        # run_spmd holds every rank's net to rank 0's after each epoch
        # and raises on a difference, before rank 0 writes the epoch's
        # metrics: rc 0 with epochs 0 and 1 written means equal nets.
        epochs = [m["epoch"] for m in lines]
        print(f"  nets equal on both ranks after epochs {epochs}: "
              f"{proc.returncode == 0 and epochs == [0, 1]}")
        if epochs != [0, 1]:
            bad.append(f"epochs {epochs}")
        per_rank = result.get("kernel_launches", [])
        for rank in (0, 1):
            n = (per_rank[rank].get("grid2_cfr", 0)
                 if rank < len(per_rank) else 0)
            print(f"  rank {rank}: grid2_cfr launches {n}")
            launches["grid2_cfr"] += n
            if n == 0:
                bad.append(f"rank {rank}: no grid2_cfr launch")
        print(f"check spmd two ranks on one card (run entry, "
              f"{result.get('backend')}): {wall:.1f} s wall, "
              f"{'ok' if not bad else 'MISS: ' + '; '.join(bad)}")
        if bad:
            failures.append(f"spmd two ranks: {bad}")

    def spmd_parity(tmp: pathlib.Path) -> None:
        """(c) the train step and (d) the hands axis, on two gloo ranks
        sharing the card."""
        import spmd_parity as parity

        from rebel_tpu_torch.selfplay.fast_runner import FastSelfPlayEngine

        g = torch.Generator().manual_seed(41)
        net = CFVNet(game, 256, 2, True, generator=g)
        local = 512 // 2
        rings = [{"queries": torch.rand(SPMD_RING_ROWS, game.query_size,
                                        generator=g),
                  "values": torch.randn(SPMD_RING_ROWS, game.num_hands,
                                        generator=g) * 0.5,
                  "priorities": torch.ones(SPMD_RING_ROWS),
                  "head": 0, "size": SPMD_RING_ROWS,
                  "num_add": SPMD_RING_ROWS} for _ in range(2)]
        env = dict(num_dice=1, num_faces=4, num_iters=SPMD_HANDS_ITERS,
                   use_cfr=True)
        cases = {
            "train_step": {
                "trainer": dict(env=env, selfplay_batch=1024,
                                train_batch_size=512, replay_capacity=8192),
                "net": net.state_dict(), "rings": rings,
                "indices": torch.randint(0, SPMD_RING_ROWS,
                                         (SPMD_STEPS, 2, local),
                                         generator=g)},
            "hands": {"env": env, "dtype": "float64", "hands": 2,
                      "net": net.state_dict(), "lanes": SPMD_HANDS_LANES,
                      "steps": 2, "seed": 43}}
        t0 = time.perf_counter()
        outs = parity.run_group(cases, 2, tmp / "parity", device="cuda",
                                timeout=SPMD_TIMEOUT)
        wall = time.perf_counter() - t0
        ts = [o["train_step"] for o in outs]
        rel = max(o["grad_rel"] for o in ts)
        same = all(torch.equal(ts[1]["nets"][s][k], ts[0]["nets"][s][k])
                   for s in range(SPMD_STEPS) for k in ts[0]["nets"][s])
        ok = rel <= SPMD_GRAD_RTOL and same
        print(f"check spmd train step (2 gloo ranks on the card, local batch "
              f"{local}, f32): averaged gradient against one process's on "
              f"both batches: relative max diff {rel:.3e} (limit "
              f"{SPMD_GRAD_RTOL:.0e}); nets equal across ranks after "
              f"{SPMD_STEPS} steps: {same} {'ok' if ok else 'MISS'}")
        if not ok:
            failures.append("spmd train step parity")
        cfg = parity.recursive_params(env)
        ref = parity.engine_steps(
            FastSelfPlayEngine(cfg, torch.float64),
            copy.deepcopy(net).to(dev, torch.float64), SPMD_HANDS_LANES, 2,
            43, dev, torch.float64)
        worst = max(float((o["hands"]["engine"][s][k].double()
                           - ref[s][k].double()).abs().max())
                    for o in outs for s in range(2) for k in ref[s])
        ok = worst <= SPMD_HANDS_ATOL
        print(f"check spmd hands (2 gloo ranks on the card, 1x4f, H=4, "
              f"{SPMD_HANDS_LANES} lanes, {SPMD_HANDS_ITERS} iterations, "
              f"f64, 2 steps): split against unsplit fast engine max abs "
              f"diff {worst:.3e} (limit {SPMD_HANDS_ATOL:.0e}) "
              f"{'ok' if ok else 'MISS'}; {wall:.1f} s wall for both")
        if not ok:
            failures.append("spmd hands parity")

    if "spmd" in phases:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            spmd_world1(pathlib.Path(tmp))
            spmd_two_ranks(pathlib.Path(tmp))
            spmd_parity(pathlib.Path(tmp))
        lap("spmd")

    print(f"phase host seconds: {phase_s}")
    print(f"whole run: {time.perf_counter() - start:.1f} s, the build "
          "included")
    if failures:
        fail("; ".join(failures))
    if not whole:
        print(f"partial run (phases {phases}): no result line")
        return 0
    print(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": "rebel_tpu_torch/kernels/grid2_cfr.cu",
        "replaces": replaces,
        "launches": launches[kernel],
        **measured[kernel],
        "library_ms": None,
    } for kernel, replaces in (
        ("grid2_cfr", "rebel_tpu/solving/grid2p.py:844"),
        ("grid2_fp", "rebel_tpu/solving/grid2p.py:554"),
        ("grid2_cfr_il2", "rebel_tpu/solving/grid2p.py:762"),
    )]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
