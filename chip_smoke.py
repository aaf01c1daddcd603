#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rebel_tpu_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA GPU (written for
an H100, ``sm_90a``).  It

1. prints the card's name and power limit and builds the fused depth-2
   CFR kernel (``rebel_tpu_torch/kernels/grid2_cfr.cu``) with ``nvcc``;
2. holds the kernel against its plain PyTorch version
   (``solving.grid2p.solve_reference``) on the card at 1x4f, B=256: f32
   with LayerNorm, f32 without LayerNorm, no net, bf16 with the fast GELU,
   DCFR (plain and clamped), CFR without discounts, and 1 and 3 hidden
   layers; over 4 iterations to an absolute limit and over 64 iterations
   (1024 without a net) by statistics limited by a
   plain(card)-vs-plain(cpu) control;
3. trains the 1x4f 256x2 CFR self-play trainer at full width (1024
   iterations, 1024 lanes, bf16 MLP, batch 512) for burn-in and two
   epochs through that kernel, with the kernel's launch count reset just
   before and read just after;
4. holds the kernel to its plain version at the main path's shapes
   (4 iterations on random states; 1024 iterations on the walked
   episodes), times both and the bound, and prints them as one
   ``{"kernels": [...]}`` line;
5. prints ``{"ok": true, "device": {...}}`` as the last line.

It exits non-zero, printing no result, without CUDA, outside a checkout,
or when any check fails.  Weights and data are random, made from seeds.
"""

from __future__ import annotations

import copy
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
H100_BF16_FLOPS = 989e12
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
CONTROL_LANES = 256  # lanes of the 1024-iteration control run on the CPU


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs on the card only")
    if not (ROOT / "rebel_tpu_torch" / "kernels" / "grid2_cfr.cu").is_file():
        fail("run chip_smoke.py from the root of a checkout of the repo")
    sys.path.insert(0, str(ROOT))

    from rebel_tpu_torch.games.liars_dice import LiarsDice
    from rebel_tpu_torch.kernels import build
    from rebel_tpu_torch.nets.cfv_net import CFVNet
    from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.solving.params import SubgameSolvingParams
    from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures: list[str] = []
    phase_s: dict[str, float] = {}  # host seconds per phase
    mark = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        phase_s[name] = round(now - mark, 1)
        mark = now

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
    print(f"kernel build: grid2_cfr {build.build_seconds['grid2_cfr']:.1f} s")
    for line in build.build_log("grid2_cfr").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    lap("build")
    game = LiarsDice(1, 4)
    A, H = game.num_actions, game.num_hands

    def random_inputs(batch: int, num_iters: int, seed: int):
        g = torch.Generator().manual_seed(seed)
        bids = torch.randint(-1, A - 1, (batch,), generator=g)
        players = torch.randint(0, 2, (batch,), generator=g)
        expo = -torch.log(torch.rand((batch, 2, H), generator=g))
        beliefs = expo / expo.sum(-1, keepdim=True)  # Dirichlet(1)
        t_stop = torch.randint(0, num_iters + 1, (batch,), generator=g)
        return [x.to(dev) for x in (bids, players, beliefs, t_stop)]

    def max_diff(a, b) -> float:
        return max(float((x.cpu() - y.cpu()).abs().max())
                   for x, y in zip(a, b))

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
                   keep=None, keep_part=None) -> None:
        """Kernel ``out`` vs plain ``ref`` on the card, limited by the
        control: plain ``ref_part`` (the same lanes as ``cpu``) vs the
        plain version on the CPU.  ``keep``/``keep_part``: lanes counted."""
        if keep is None:
            keep = torch.ones(out.rvm.shape[0], dtype=torch.bool)
        if keep_part is None:
            keep_part = torch.ones(cpu.rvm.shape[0], dtype=torch.bool)
        got = lane_stats(out, ref, keep)
        ctl = lane_stats(ref_part, cpu, keep_part)
        ok, parts = finite(out), []
        for key, x in got.items():
            if key in keys:
                lim = max(LONG_FACTOR[key] * ctl[key], LONG_FLOOR[key])
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

    # ---------------------------------------- 2. kernel vs plain version
    def cfr(num_iters, **kw):
        kw.setdefault("linear_update", True)
        return SubgameSolvingParams(num_iters=num_iters, max_depth=2,
                                    use_cfr=True, **kw)

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
        ("f32_plain_cfr", dict(linear_update=False), 2, True, torch.float32),
        ("f32_1layer", {}, 1, True, torch.float32),
        ("f32_3layers", {}, 3, True, torch.float32),
    ]
    for k, (name, kw, layers, use_ln, dtype) in enumerate(modes):
        net = net_dev = None
        if layers:
            net = CFVNet(game, 256, layers, use_ln,
                         generator=torch.Generator().manual_seed(10 + k))
            net_dev = copy.deepcopy(net).to(dev)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        for iters in ((CHECK_ITERS, LONG_ITERS)
                      + ((NONET_ITERS,) if net is None else ())):
            inputs = random_inputs(256, iters, 20 + k)
            args = (game, cfr(iters, **kw), *inputs, net_dev)
            out = grid2p.solve(*args, dtype)
            ref = grid2p.solve_reference(*args, dtype)
            label = f"{name}: B=256 iters={iters}"
            if iters == CHECK_ITERS:
                short_check(label, out, ref, tol)
                if dtype == torch.bfloat16:
                    precision_control(label, args, tol)
                continue
            cpu = grid2p.solve_reference(
                game, cfr(iters, **kw), *[x.cpu() for x in inputs], net,
                dtype)
            long_check(label, out, ref, ref, cpu)

    lap("checks")

    # ------------------------------------------------ 3. the main path
    sub = cfr(1024)
    cfg = TrainerConfig(
        env=RecursiveSolvingParams(num_dice=1, num_faces=4,
                                   subgame_params=sub,
                                   random_action_prob=0.25, sample_leaf=True),
        n_hidden=256, n_layers=2, use_layer_norm=True,
        train_epoch_size=25600, train_batch_size=512, train_gen_ratio=4,
        selfplay_batch=1024, net_compute_dtype=torch.bfloat16, seed=0,
    )
    trainer = Trainer(cfg, device="cuda")
    grid2p.solve.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.run(max_epochs=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = grid2p.solve.launches

    solve_ms = [s.elapsed_time(e) for s, e in trainer.engine.solve_events]
    mean_solve_ms = sum(solve_ms) / len(solve_ms)
    B, iters = cfg.selfplay_batch, sub.num_iters
    flops = grid2p.mlp_flops_per_lane_iter(game, cfg.n_hidden,
                                           cfg.n_layers) * B * iters
    gen_s = sum(m["timing/gen"] for m in metrics) + metrics[0][
        "timing/burn_in"]
    gen_examples = 2 * B * trainer.gen_steps
    train_s = sum(m["timing/train"] for m in metrics)
    steps = trainer.steps_per_epoch * len(metrics)
    losses = [m["loss/train"] for m in metrics]
    print(f"main path: 1x4f CFVNet 256x2 LN, linear CFR {iters} iters, "
          f"{B} lanes, bf16 MLP, batch {cfg.train_batch_size}: "
          f"burn-in + {len(metrics)} epochs in {wall_s:.2f} s, "
          f"{trainer.gen_steps} batch_steps, {launches} kernel launches")
    print(f"  solve ms per batch_step: {mean_solve_ms:.3f} "
          f"(min {min(solve_ms):.3f}, max {max(solve_ms):.3f}; CUDA events)")
    print(f"  CFR subgame-iters/s: {B * iters / (mean_solve_ms / 1e3):.4e}")
    print(f"  MLP FLOP/s: {flops / (mean_solve_ms / 1e3):.4e} "
          f"({flops:.4e} FLOP per batch_step)")
    print(f"  examples/s: {gen_examples / gen_s:.1f} "
          f"({gen_examples} examples, generation {gen_s:.2f} s)")
    print(f"  train steps/s: {steps / train_s:.2f} ({steps} steps)")
    print(f"  loss/train per epoch: {losses}")
    if launches == 0:
        failures.append("the main path launched the kernel no time")
    if launches != trainer.gen_steps:
        failures.append(f"{launches} launches for {trainer.gen_steps} "
                        "batch_steps")
    if not all(math.isfinite(x) for x in losses):
        failures.append("non-finite training loss")
    rp = trainer.replay
    if not (finite((rp.queries[:rp.size], rp.values[:rp.size]))
            and rp.num_add == gen_examples):
        failures.append("replay holds non-finite or missing rows")
    bel_sums = trainer.episodes.beliefs.sum(-1)
    if not torch.allclose(bel_sums, torch.ones_like(bel_sums), atol=1e-4):
        failures.append("episode beliefs do not sum to one")

    lap("main path")

    # ------------- 4. the kernel at the main path's shapes: time and bound
    # The trained net in bf16 at B=1024.  Over CHECK_ITERS iterations the
    # kernel is held to its plain version on random states: the walked
    # states hold exact ties between two actions' values, which f32
    # rounding breaks one way in one version and the other way (or not at
    # all) in the other, so that lane's policy differs by up to 1 from the
    # first iteration.  Over the main path's iterations it is held on the
    # walked states by the statistics of long_check, whose share of lanes
    # absorbs such ties.
    ep = trainer.episodes
    gen = torch.Generator(dev).manual_seed(7)

    def main_args(num_iters, states):
        t_stop = torch.randint(0, num_iters + 1, (B,), device=dev,
                               generator=gen)
        return (game, cfr(num_iters), *states, t_stop, trainer.net)

    args = main_args(CHECK_ITERS, random_inputs(B, CHECK_ITERS, 30)[:3])
    label = f"bf16 main shapes: B={B} iters={CHECK_ITERS}"
    err = short_check(label, grid2p.solve(*args, torch.bfloat16),
                      grid2p.solve_reference(*args, torch.bfloat16),
                      TOL_BF16_TRAINED)
    precision_control(label, args, TOL_BF16_TRAINED)

    walked = (ep.root_bid, ep.root_player, ep.beliefs)
    args = main_args(CHECK_ITERS, walked)
    ties = snap_diff(grid2p.solve(*args, torch.bfloat16),
                     grid2p.solve_reference(*args, torch.bfloat16)) > LANE_TOL
    share = float(ties.float().mean())
    print(f"walked episodes: B={B} iters={CHECK_ITERS} {int(ties.sum())} "
          f"lanes with exact value ties (share {share:.3e}, limit "
          f"{TIE_SHARE:.0e}) {'ok' if share <= TIE_SHARE else 'MISS'}")
    if share > TIE_SHARE:
        failures.append("walked episodes: too many lanes differ within "
                        f"{CHECK_ITERS} iterations")
    args = main_args(iters, walked)
    out = grid2p.solve(*args, torch.bfloat16)  # warm
    torch.cuda.synchronize()
    reps = 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = grid2p.solve(*args, torch.bfloat16)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end) / reps
    start.record()
    ref = grid2p.solve_reference(*args, torch.bfloat16)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    n = CONTROL_LANES
    cpu = grid2p.solve_reference(game, args[1],
                                 *[x[:n].cpu() for x in args[2:6]],
                                 copy.deepcopy(trainer.net).cpu(),
                                 torch.bfloat16)
    long_check(f"bf16 main shapes, walked episodes: B={B} iters={iters} "
               f"(ties left out; control on {n} lanes)", out, ref,
               grid2p.Grid2Outputs(*(x[:n] for x in ref)), cpu,
               keys=("rvm_mean", "rvm_max"), keep=~ties, keep_part=~ties[:n])
    lap("main shapes")
    print(f"phase host seconds: {phase_s}")
    net_bytes = sum(p.numel() * (2 if p.dim() == 2 else 4)
                    for p in trainer.net.parameters())
    io_bytes = 4 * B * (2 * H + 3 + 2 * H + H * A + A * H * A) + net_bytes
    bound_s = max(flops / H100_BF16_FLOPS, io_bytes / H100_HBM_BYTES_PER_S)
    bound_by = ("operations" if flops / H100_BF16_FLOPS
                >= io_bytes / H100_HBM_BYTES_PER_S else "bytes")
    print(f"kernel grid2_cfr: {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_s * 1e3:.3f} ms ({bound_by}: {flops:.4e} FLOP at "
          f"bf16 peak, {io_bytes} B), {flops / (kernel_ms / 1e3):.4e} FLOP/s")

    if failures:
        fail("; ".join(failures))
    print(json.dumps({"kernels": [{
        "name": "grid2_cfr",
        "route": "cuda",
        "source": "rebel_tpu_torch/kernels/grid2_cfr.cu",
        "replaces": "rebel_tpu/solving/grid2p.py:844",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
