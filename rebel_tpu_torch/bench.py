"""Generation benchmark of the port: subgame-iterations per second at 1x4f.

    python -m rebel_tpu_torch.bench [--fp | --no-net] [--interleave 2] ...

Counterpart of the JAX package's ``bench.py``.  It measures the self-play
hot path: ``batch_step``s of a depth-2 engine (the whole solve with the
CFV MLP at every pseudo-leaf on every iteration, then the walk) on 1x4f
Liar's Dice with a 256x2 net with LayerNorm, random weights from a seed,
bf16 MLP operands.  Whole ``batch_step``s are timed between
synchronisations after one warm-up step.  It prints one JSON line at once,

    {"metric": ..., "value": N, "unit": "iters/s", "vs_baseline": null,
     "detail": {...}}

and, unless the run is narrowed to one mode (``--headline-only``, ``--fp``,
``--no-net``), a second line with the same headline and the fictitious-play
and no-net rates beside it.  ``value`` is subgame-iterations per second:
lanes x steps x iterations over the wall time.  ``detail`` also holds the
kernel's own seconds (CUDA events around every launch), the launches by
kernel name, the MLP's model FLOP/s and its share of the H100's dense bf16
peak, and the card's name and power limit.  ``vs_baseline`` stays null: the
JAX package's baseline was measured on another host, and its TPU figures
set no target here.

It runs on the card.  Without CUDA it exits non-zero unless ``--device
cpu`` is given, which runs the plain versions (a check that the entry
works, not a measurement of a device).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.selfplay.fast_runner import make_engine
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

# Published dense bf16 peak of one H100 SXM (NVIDIA data sheet), at 700 W.
H100_BF16_FLOPS = 989e12
N_HIDDEN, N_LAYERS = 256, 2
# Defaults of --batch, --lane-block and --mlp-chunks, from the sweep of
# rebel_tpu_torch/bench_sweep.py on an H100 (PERF.md): lane_block None lets
# the wrapper choose (grid2p.choose_lane_block: 8 at 1x4f for CFR and
# fictitious play alike, the largest block whose state fits beside the
# bf16 MLP block in shared memory), and the batch puts one block on each
# of the 132 SMs; mlp_chunks None lets the wrapper choose
# (grid2p.default_mlp_chunks: one group of pairs, the least row padding).
DEFAULT_BATCH = 1056
DEFAULT_LANE_BLOCK = None
DEFAULT_MLP_CHUNKS = None


def card_name_and_power_limit() -> str | None:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def measure(batch: int, num_iters: int, steps: int, warmup: int = 1,
            layout: str = "kernel", no_net: bool = False,
            lane_block: int | None = DEFAULT_LANE_BLOCK,
            mlp_chunks: int | None = DEFAULT_MLP_CHUNKS, ablate: str = "",
            gelu: str = "auto", use_cfr: bool = True, interleave: int = 1,
            device: str = "cuda") -> dict:
    """Time ``steps`` whole ``batch_step``s of ``batch`` lanes after
    ``warmup`` untimed ones.  ``layout="kernel"`` is the fused solve,
    ``"plain"`` the batch-last solver in plain PyTorch, ``"batch_first"``
    the batch-first one (the ``fast`` engine, its net in bf16; it needs a
    net, as the JAX package's does)."""
    cfg = RecursiveSolvingParams(
        num_dice=1, num_faces=4,
        subgame_params=SubgameSolvingParams(
            num_iters=num_iters, max_depth=2, linear_update=True,
            use_cfr=use_cfr),
        random_action_prob=0.25, sample_leaf=True)
    if layout == "kernel":
        engine = make_engine(
            cfg, kind="kernel", net_compute_dtype=torch.bfloat16,
            lane_block=lane_block, mlp_chunks=mlp_chunks, ablate=ablate,
            gelu=gelu, interleave=interleave)
    elif layout == "batch_first":
        engine = make_engine(cfg, kind="fast")
    else:
        engine = make_engine(cfg, kind="batched",
                             net_compute_dtype=torch.bfloat16)
    game = cfg.game
    net = None
    if not no_net:
        net = CFVNet(game, N_HIDDEN, N_LAYERS, True,
                     generator=torch.Generator().manual_seed(0)).to(device)
        if layout == "batch_first":
            net = net.to(torch.bfloat16)
    eps = EpisodeState.initial_batch(game, batch, device)
    gen = torch.Generator(device).manual_seed(1)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    for _ in range(warmup):
        eps, out = engine.batch_step(eps, net, gen)
    sync()
    before = dict(grid2p.solve.launches_by_kernel)
    grid2p.solve.events = [] if on_card else None
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            eps, out = engine.batch_step(eps, net, gen)
        checksum = float(out.values.sum())  # waits for the device
        wall = time.perf_counter() - t0
        events = grid2p.solve.events or []
    finally:
        grid2p.solve.events = None
    if not math.isfinite(checksum):
        raise RuntimeError(f"non-finite checksum {checksum}")
    launches = {k: n - before[k]
                for k, n in grid2p.solve.launches_by_kernel.items()
                if n != before[k]}
    subgames = batch * steps
    return {
        "wall_s": wall,
        "subgames_per_s": subgames / wall,
        "iters_per_s": subgames * num_iters / wall,
        "examples_per_s": 2 * subgames / wall,
        # The fused kernel's own time; None where none was launched.
        "kernel_s": (sum(s.elapsed_time(e) for _, s, e in events) / 1e3
                     if events else None),
        "launches": launches,
        # The lane block the kernel launched with (None: no launch).
        "lane_block": grid2p.solve.last_lane_block if launches else None,
        "checksum": checksum,
    }


# What a watchdog or a signal prints when the run is cut: the headline if
# it was measured, and where the run stood.
_progress = {"stage": "startup", "headline": None}


def _emit_partial(reason: str) -> None:
    head = _progress["headline"]
    print(json.dumps({
        "metric": head["metric"] if head else "subgame-iters/s",
        "value": head["value"] if head else None,
        "unit": "iters/s",
        "vs_baseline": None,
        "error": f"{reason} (stage: {_progress['stage']})",
    }), flush=True)


def _install_watchdogs(deadline_s: float):
    import signal
    import threading

    def expire():
        _emit_partial(f"watchdog expired after {deadline_s:.0f}s")
        os._exit(3)

    timer = threading.Timer(deadline_s, expire)
    timer.daemon = True
    timer.start()

    def on_term(signum, frame):
        _emit_partial(f"killed by signal {signum}")
        os._exit(4)

    signal.signal(signal.SIGTERM, on_term)
    return timer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--num_iters", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--smoke", action="store_true", help="tiny fast run")
    ap.add_argument("--cycles", type=int, default=0,
                    help="before the headline, run this many measurements "
                    "and print items and items per second after each")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace of the headline "
                    "measurement to this directory")
    ap.add_argument("--layout", default="kernel",
                    choices=("kernel", "plain", "batch_first"),
                    help="kernel: the fused solve; plain: the batch-last "
                    "solver in plain PyTorch; batch_first: the batch-first "
                    "one (the fast engine)")
    ap.add_argument("--no-net", action="store_true",
                    help="solver only (zero leaf values, no MLP)")
    ap.add_argument("--lane-block", type=int, default=DEFAULT_LANE_BLOCK,
                    help="lanes a block solves (default: the wrapper "
                    "chooses from the game and the batch)")
    ap.add_argument("--mlp-chunks", type=int, default=DEFAULT_MLP_CHUNKS)
    ap.add_argument("--interleave", type=int, default=1,
                    help="2: two groups of warps per block, each with half "
                    "the lanes (CFR with a net only)")
    ap.add_argument("--ablate", default="", choices=grid2p.ABLATIONS,
                    help="what the activation and LayerNorm cost")
    ap.add_argument("--fp", action="store_true",
                    help="fictitious play instead of CFR")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the FP and no-net side measurements")
    ap.add_argument("--gelu", default="auto", choices=grid2p.GELUS)
    ap.add_argument("--deadline", type=float, default=540.0,
                    help="seconds after which a partial JSON line is "
                    "printed and the process exits (0: none)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.num_iters, args.steps = 64, 32, 2
    return args


def main(argv=None) -> list[dict]:
    """Run the benchmark; returns the JSON lines it printed, as dicts."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rebel_tpu_torch.bench: CUDA is not available; this benchmark "
              "measures the card (--device cpu runs the plain versions)",
              file=sys.stderr)
        raise SystemExit(1)
    if args.deadline and not (args.cycles or args.profile):
        _install_watchdogs(args.deadline)
    on_card = args.device == "cuda"
    kw = dict(layout=args.layout, no_net=args.no_net,
              lane_block=args.lane_block, mlp_chunks=args.mlp_chunks,
              ablate=args.ablate, gelu=args.gelu, use_cfr=not args.fp,
              interleave=args.interleave, device=args.device)
    printed: list[dict] = []

    def emit(line: dict) -> None:
        printed.append(line)
        print(json.dumps(line), flush=True)

    if args.cycles:
        total_items = 0
        t_start = time.perf_counter()
        for cycle in range(args.cycles):
            r = measure(args.batch, args.num_iters, args.steps,
                        warmup=1 if cycle == 0 else 0, **kw)
            total_items += 2 * args.batch * args.steps
            elapsed = time.perf_counter() - t_start
            print(f"cycle {cycle}: items {total_items} "
                  f"per_second {total_items / elapsed:.2f}", flush=True)

    _progress["stage"] = "headline"
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            res = measure(args.batch, args.num_iters, args.steps, **kw)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        with open(os.path.join(args.profile, "key_averages.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="cuda_time_total" if on_card else "cpu_time_total",
                row_limit=40))
    else:
        res = measure(args.batch, args.num_iters, args.steps, **kw)

    game = RecursiveSolvingParams(num_dice=1, num_faces=4).game
    side: dict = {}
    if not args.no_net:
        achieved = res["iters_per_s"] * grid2p.mlp_flops_per_lane_iter(
            game, N_HIDDEN, N_LAYERS)
        side["mlp_model_flops_per_s"] = achieved / 1e12
        side["mlp_model_flops_unit"] = "TFLOP/s (bf16, unpadded)"
        # A share of the card's peak is a device metric: none on the CPU.
        side["mfu"] = achieved / H100_BF16_FLOPS if on_card else None
        side["peak_bf16_tflops_assumed"] = H100_BF16_FLOPS / 1e12

    def headline_line() -> dict:
        return {
            "metric": ("FP" if args.fp else "CFR")
            + " subgame-iters/s per chip (1x4f, depth-2, "
            + ("no net" if args.no_net else "CFV net fused") + ")",
            "value": res["iters_per_s"],
            "unit": "iters/s",
            "vs_baseline": None,
            "detail": {
                "subgames_per_s": res["subgames_per_s"],
                "examples_per_s": res["examples_per_s"],
                "batch": args.batch,
                "num_iters": args.num_iters,
                "steps": args.steps,
                "wall_s": res["wall_s"],
                "kernel_s": res["kernel_s"],
                "launches": res["launches"],
                "checksum": res["checksum"],
                "layout": args.layout,
                "lane_block": res["lane_block"],
                "mlp_chunks": args.mlp_chunks,
                "interleave": args.interleave,
                "gelu": args.gelu,
                "ablate": args.ablate,
                "device": args.device,
                "device_kind": (torch.cuda.get_device_name(0) if on_card
                                else "cpu"),
                "card": card_name_and_power_limit() if on_card else None,
                **side,
            },
        }

    # The headline at once: a run cut during the side measurements has
    # then printed what it measured.  The second line repeats it.
    _progress["headline"] = headline_line()
    emit(_progress["headline"])

    if not (args.headline_only or args.fp or args.no_net):
        side_steps = max(1, args.steps // 2)
        for name, key, change in (
                ("fp", "fp_iters_per_s", {"use_cfr": False}),
                ("no-net", "no_net_cfr_iters_per_s", {"no_net": True})):
            _progress["stage"] = f"side measurement: {name}"
            r = measure(args.batch, args.num_iters, side_steps,
                        **{**kw, **change})
            side[key] = r["iters_per_s"]
            side[key.replace("iters_per_s", "kernel_s")] = r["kernel_s"]
            side[key.replace("iters_per_s", "launches")] = r["launches"]
        side["side_steps"] = side_steps
        _progress["stage"] = "done"
        emit(headline_line())
    return printed


if __name__ == "__main__":
    main()
