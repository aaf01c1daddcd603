"""Sweep of the generation benchmark's knobs on the card.

    python -m rebel_tpu_torch.bench_sweep [--steps 2] [--out FILE]

Runs ``rebel_tpu_torch.bench.measure`` (1x4f, 256x2 net, 1024 iterations,
bf16) over lane blocks, batches, ``mlp_chunks`` and ``interleave``, then the
three ablations, fictitious play, the no-net mode and the plain layout at
the benchmark's defaults, and prints one JSON line per point with subgame-iterations per second
(whole ``batch_step``s) and the kernel's own seconds per launch.  A point
whose staging does not fit a block's shared memory is printed with the
wrapper's error, which names the bytes needed.  The defaults of
``rebel_tpu_torch.bench`` are chosen from this sweep (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rebel_tpu_torch import bench

SMS = 132  # an H100's streaming multiprocessors: one block runs on each


def point(out, steps: int, num_iters: int, **kw) -> dict:
    row = dict(kw)
    try:
        r = bench.measure(num_iters=num_iters, steps=steps, **kw)
    except ValueError as e:  # the staging does not fit
        row["error"] = str(e)
    else:
        row.update(
            iters_per_s=r["iters_per_s"], wall_s=r["wall_s"],
            kernel_ms_per_launch=(None if r["kernel_s"] is None
                                  else r["kernel_s"] * 1e3 / steps),
            launches=r["launches"])
    print(json.dumps(row), flush=True)
    if out is not None:
        out.write(json.dumps(row) + "\n")
        out.flush()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--num_iters", type=int, default=1024)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sweep: CUDA is not available", file=sys.stderr)
        return 1
    out = open(args.out, "w") if args.out else None
    print(json.dumps({"card": bench.card_name_and_power_limit(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    run = lambda **kw: point(out, args.steps, args.num_iters, **kw)

    rows = []
    # Lane block x mlp_chunks x interleave at one wave of blocks (one block
    # on each SM).
    for lane_block in (2, 4, 8, 16):
        for mlp_chunks in (1, 2, 4, 7, 14):
            for interleave in (1, 2):
                rows.append(run(batch=SMS * lane_block, lane_block=lane_block,
                                mlp_chunks=mlp_chunks,
                                interleave=interleave))
    good = [r for r in rows if "error" not in r]
    best = max(good, key=lambda r: r["iters_per_s"])
    knobs = {k: best[k] for k in ("lane_block", "mlp_chunks", "interleave")}
    print(json.dumps({"best": best}), flush=True)
    # Batch at the best knobs (and at the default lane block of 8): small
    # frontiers (256 lanes), the trainer's 1024, whole waves.
    for lane_block in sorted({best["lane_block"], 8, 2}):
        k = {**knobs, "lane_block": lane_block}
        if lane_block != best["lane_block"]:
            same = [r for r in good if r["lane_block"] == lane_block
                    and r["interleave"] == knobs["interleave"]]
            k["mlp_chunks"] = max(
                same, key=lambda r: r["iters_per_s"])["mlp_chunks"]
        for batch in (256, 512, 1024, SMS * 8, 2 * SMS * 8, 4 * SMS * 8,
                      16384):
            if batch % lane_block == 0:
                run(batch=batch, **k)
    # The other modes at the benchmark's defaults.
    for extra in (dict(), dict(ablate="nogelu"), dict(ablate="noln"),
                  dict(ablate="cheaperf"), dict(gelu="exact"),
                  dict(interleave=2), dict(use_cfr=False),
                  dict(no_net=True), dict(use_cfr=False, no_net=True),
                  dict(layout="plain")):
        run(batch=bench.DEFAULT_BATCH, **extra)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
