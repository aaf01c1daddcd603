"""Run entry of the port, the counterpart of the JAX package's ``run.py``
(single-process part): ``-c/--cfg`` config, ``--adhoc``, ``--mode``,
``--out_root``, ``--exp_dir``, ``--device`` and dotted ``key=value``
overrides.

    python -m rebel_tpu_torch.run --cfg conf/liars_sp.yaml \\
        selfplay.engine=pallas selfplay.net_compute_dtype=bf16 \\
        env.subgame_params.use_cfr=true
    python -m rebel_tpu_torch.run --cfg conf/liars_sp.yaml \\
        --mode start_continue --exp_dir outputs/liars_sp/<dir>
    python -m rebel_tpu_torch.run --cfg conf/liars_sp.yaml --device cpu \\
        --adhoc max_epochs=2 selfplay.batch=16 data.train_epoch_size=256 \\
        env.subgame_params.num_iters=16 model.kwargs.n_hidden=32

The experiment dir receives ``config.json``, ``heartbeat``,
``metrics.jsonl``, ``ckpt/`` and ``result.json``.  ``--mode
start_continue`` resumes from the newest readable ``ckpt/epoch<N>.ckpt``.
Tasks: ``selfplay`` (the default) and ``eval`` (``eval.*`` keys, see
:func:`rebel_tpu_torch.eval.recursive_eval.run_eval_from_config`).
Everything runs on the card unless ``--device cpu`` is given.

Not taken yet: ``--mode submit/kill/cluster_status`` (cluster management
of the JAX package) and several processes (``launcher.num_processes > 1``,
``launcher.spmd``).
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import platform
import subprocess
import sys
import time
from typing import NamedTuple

from rebel_tpu_torch import config as cfglib

MANAGEMENT_MODES = ("kill", "submit", "cluster_status")


class Run(NamedTuple):
    code: int
    exp_dir: pathlib.Path
    result: dict | None
    trainer: object | None  # the Trainer of a selfplay task


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname).1s%(asctime)s [%(name)s] %(message)s",
        datefmt="%m%d %H:%M:%S",
    )


def log_provenance(log, device) -> None:
    """Git SHA and dirty state of the checkout, host, Python, torch and
    CUDA versions and the card, so a result dir can be traced back."""
    import torch

    def git(*argv):
        try:
            return subprocess.run(
                ["git", *argv], capture_output=True, text=True, timeout=10,
                cwd=pathlib.Path(__file__).resolve().parent,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return "<unavailable>"

    sha = git("rev-parse", "HEAD") or "<unavailable>"
    dirty = git("status", "--porcelain")
    log.info("Git SHA: %s%s", sha, " (dirty)" if dirty else "")
    log.info("Host: %s | Python %s | torch %s | CUDA %s", platform.node(),
             platform.python_version(), torch.__version__, torch.version.cuda)
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        log.info("Device: %s (%d visible)", torch.cuda.get_device_name(0),
                 torch.cuda.device_count())
    else:
        log.info("Device: %s", device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--cfg", required=True)
    ap.add_argument("--adhoc", action="store_true")
    ap.add_argument("--mode", default="gentle_start",
                    choices=cfglib.MODES + MANAGEMENT_MODES)
    ap.add_argument("--out_root", default="outputs")
    ap.add_argument("--exp_dir", default=None,
                    help="pin the experiment dir instead of deriving it "
                    "from config + overrides")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card); 'cpu' runs the "
                    "kernels' plain versions")
    ap.add_argument("overrides", nargs="*", help="dotted key=value")
    return ap.parse_intermixed_args(argv)


def execute(argv=None) -> Run:
    """Parse ``argv``, run the task and write ``result.json``."""
    args = parse_args(argv)
    setup_logging()
    log = logging.getLogger("run")
    if args.mode in MANAGEMENT_MODES:
        raise SystemExit(f"--mode {args.mode} (cluster management) is not "
                         "ported to rebel_tpu_torch")
    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available "
                         "(pass --device cpu to run the plain versions)")
    cfg = cfglib.load_yaml_config(args.cfg)
    cfg = cfglib.apply_overrides(cfg, args.overrides)
    task = cfg.pop("task", "selfplay")
    launcher = cfg.pop("launcher", {}) or {}
    if int(launcher.get("num_processes", 1) or 1) > 1 or launcher.get("spmd"):
        raise SystemExit(
            "launcher.num_processes > 1 and launcher.spmd (the SPMD path) "
            "are not ported to rebel_tpu_torch yet; run one process")
    if launcher:
        log.info("launcher keys %s unused by a single process",
                 sorted(launcher))
    exp_dir = (pathlib.Path(args.exp_dir) if args.exp_dir
               else cfglib.exp_dir_for(args.cfg, args.overrides,
                                       args.out_root, adhoc=args.adhoc))
    log.info("Config: %s", json.dumps(cfg))
    log.info("Experiment dir: %s", exp_dir)
    log_provenance(log, args.device)
    if not cfglib.handle_dst(exp_dir, args.mode):
        log.info("Nothing to do (mode=%s)", args.mode)
        return Run(0, exp_dir, None, None)
    (exp_dir / "config.json").write_text(json.dumps(cfg, indent=1))
    (exp_dir / "heartbeat").touch()

    trainer = None
    if task == "selfplay":
        from rebel_tpu_torch.training.trainer import Trainer, checkpoints

        trainer = Trainer(cfglib.cfg_to_trainer_config(cfg),
                          device=args.device, out_dir=exp_dir)
        if args.mode == "start_continue":
            # Newest first; fall back over checkpoints that do not load.
            for ckpt in reversed(checkpoints(exp_dir / "ckpt")):
                try:
                    trainer.load_checkpoint(ckpt)
                    log.info("Resuming from %s (epoch %d)", ckpt,
                             trainer.epoch)
                    break
                except Exception as e:
                    log.warning("Unreadable checkpoint %s (%s); trying "
                                "older", ckpt, e)
        t0 = time.time()
        metrics = trainer.run()
        result = {"task": task, "epochs": trainer.epoch,
                  "wall_s": time.time() - t0,
                  "final": metrics[-1] if metrics else {}}
    elif task == "eval":
        from rebel_tpu_torch.eval.recursive_eval import run_eval_from_config

        result = run_eval_from_config(cfg, exp_dir, device=args.device)
    else:
        raise ValueError(f"Unknown task: {task}")
    (exp_dir / "result.json").write_text(json.dumps(result, indent=1))
    log.info("Result: %s", json.dumps(result)[:2000])
    return Run(0, exp_dir, result, trainer)


def main(argv=None) -> int:
    return execute(argv).code


if __name__ == "__main__":
    sys.exit(main())
