"""Run entry of the port, the counterpart of the JAX package's ``run.py``:
``-c/--cfg`` config, ``--adhoc``, ``--mode``,
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
    python -m rebel_tpu_torch.run --cfg conf/liars_sp.yaml \\
        launcher.num_processes=2 launcher.spmd=true [launcher.hands=2]
    python -m rebel_tpu_torch.run --cfg conf/liars_sp.yaml --mode kill \\
        --exp_dir outputs/liars_sp/<dir>

The experiment dir receives ``config.json``, ``heartbeat``,
``metrics.jsonl``, ``ckpt/`` and ``result.json``.  ``--mode
start_continue`` resumes from the newest readable ``ckpt/epoch<N>.ckpt``.
Tasks: ``selfplay`` (the default) and ``eval`` (``eval.*`` keys, see
:func:`rebel_tpu_torch.eval.recursive_eval.run_eval_from_config`).
Everything runs on the card unless ``--device cpu`` is given.

Several processes: ``launcher.num_processes=N`` starts N ranks of this
command (:func:`rebel_tpu_torch.parallel.launcher.launch_local`, each with
the internal ``--dist host:port,N,i`` and ``--mode start_continue``),
which train together by :meth:`Trainer.run_spmd`, ``launcher.hands``
ranks splitting each subgame's hands.  ``launcher.spmd=true`` in one
process starts one rank per visible card where there are several, and
trains in one process where there is one.  A process that ``torchrun`` or
Slurm started joins its group by itself.  Rank 0 alone writes
``config.json``, ``heartbeat`` and ``result.json`` (with ``processes``,
``devices``, one per rank, ``backend``, and ``kernel_launches``, each
rank's launches of the fused solve by kernel); ranks 1..N-1 log to
``log.rank<i>.txt``.  ``--mode kill`` stops the processes of a local
launch that ``jobs.json`` records.  Not taken: ``--mode submit`` and
``cluster_status``, and ``kill`` of an experiment that the JAX package
submitted to a cluster (cluster management).
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
NOT_PORTED = ("submit", "cluster_status")


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
    ap.add_argument("--dist", default=None, metavar="COORD,N,I",
                    help="(internal; appended by the launcher) join a "
                    "process group: rank 0's host:port, ranks, this rank")
    ap.add_argument("overrides", nargs="*", help="dotted key=value")
    return ap.parse_intermixed_args(argv)


def kill(args, exp_dir: pathlib.Path, log) -> Run:
    """``--mode kill``: the processes of a local launch."""
    cluster = exp_dir / "cluster.json"
    if cluster.exists() and json.loads(cluster.read_text()).get("submitted"):
        raise SystemExit("--mode kill of a cluster submission (cluster "
                         "management) is not ported to rebel_tpu_torch")
    if args.adhoc and not args.exp_dir:
        # --adhoc salts the dir name with the launch time: a new
        # invocation cannot find the running experiment's dir.
        raise SystemExit("--mode kill cannot locate an --adhoc experiment "
                         "(its dir name is time-salted); pass the printed "
                         "directory with --exp_dir")
    from rebel_tpu_torch.parallel.launcher import kill_experiment

    log.info("killed %d processes of %s", kill_experiment(exp_dir), exp_dir)
    return Run(0, exp_dir, None, None)


def kernel_launches(world: int) -> list[dict]:
    """Every rank's launches of the fused solve by kernel, in rank order
    (a collective when there are several ranks)."""
    import torch

    from rebel_tpu_torch.solving import grid2p

    mine = dict(grid2p.solve.launches_by_kernel)
    if world == 1:
        return [mine]
    every = [None] * world
    torch.distributed.all_gather_object(every, mine)
    return every


def execute(argv=None) -> Run:
    """Parse ``argv``, run the task and write ``result.json``."""
    args = parse_args(argv)
    setup_logging()
    log = logging.getLogger("run")
    if args.mode in NOT_PORTED:
        raise SystemExit(f"--mode {args.mode} (cluster management) is not "
                         "ported to rebel_tpu_torch")
    import torch

    from rebel_tpu_torch.parallel import distributed

    cfg = cfglib.load_yaml_config(args.cfg)
    cfg = cfglib.apply_overrides(cfg, args.overrides)
    task = cfg.pop("task", "selfplay")
    launcher = cfg.pop("launcher", {}) or {}
    exp_dir = (pathlib.Path(args.exp_dir) if args.exp_dir
               else cfglib.exp_dir_for(args.cfg, args.overrides,
                                       args.out_root, adhoc=args.adhoc))
    if args.mode == "kill":
        return kill(args, exp_dir, log)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available "
                         "(pass --device cpu to run the plain versions)")
    num_processes = int(launcher.get("num_processes", 1) or 1)
    hands = int(launcher.get("hands", 1) or 1)
    if launcher.get("spmd") and num_processes == 1 \
            and torch.device(args.device).type == "cuda":
        num_processes = torch.cuda.device_count()  # one rank per card
    if num_processes > 1 and num_processes % hands:
        # One process ignores launcher.hands, as the JAX package does.
        raise SystemExit(f"launcher.hands={hands} must divide the number of "
                         f"processes {num_processes}")
    log.info("Config: %s", json.dumps(cfg))
    log.info("Experiment dir: %s", exp_dir)
    if args.dist is not None:
        # A launched rank: the parent ran the experiment-dir state
        # machine, and every rank shares its dir.
        coord, n, i = args.dist.rsplit(",", 2)
        rt = distributed.initialize(coord, int(n), int(i), args.device)
    else:
        if not cfglib.handle_dst(exp_dir, args.mode):
            log.info("Nothing to do (mode=%s)", args.mode)
            return Run(0, exp_dir, None, None)
        if num_processes > 1:
            from rebel_tpu_torch.parallel.launcher import launch_local

            child_argv = ["-m", "rebel_tpu_torch.run", "--cfg", args.cfg,
                          "--mode", "start_continue", "--out_root",
                          args.out_root, "--exp_dir", str(exp_dir),
                          "--device", args.device, *args.overrides]
            code = launch_local(child_argv, num_processes, exp_dir,
                                coordinator=launcher.get("coordinator"))
            path = exp_dir / "result.json"
            result = (json.loads(path.read_text())
                      if code == 0 and path.exists() else None)
            return Run(code, exp_dir, result, None)
        rt = distributed.initialize(device=args.device)  # torchrun, Slurm
    log_provenance(log, rt.device)
    if rt.rank == 0:
        (exp_dir / "config.json").write_text(json.dumps(cfg, indent=1))
        (exp_dir / "heartbeat").touch()
    ranks = {"processes": rt.world, "devices": rt.world,
             "backend": rt.backend}

    trainer = None
    if task == "selfplay" and rt.world > 1:
        from rebel_tpu_torch.training.trainer import Trainer

        trainer = Trainer(cfglib.cfg_to_trainer_config(cfg), device=rt.device,
                          out_dir=exp_dir)
        t0 = time.time()
        _, metrics = trainer.run_spmd(
            resume=args.mode == "start_continue" or args.dist is not None,
            hands=hands)
        result = {"task": task, "epochs": len(metrics),
                  "wall_s": time.time() - t0,
                  "final": metrics[-1] if metrics else {}, **ranks}
    elif task == "selfplay":
        from rebel_tpu_torch.training.trainer import Trainer, checkpoints

        if hands > 1:
            log.info("launcher.hands=%d unused by one process", hands)
        trainer = Trainer(cfglib.cfg_to_trainer_config(cfg),
                          device=rt.device, out_dir=exp_dir)
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
                  "final": metrics[-1] if metrics else {}, **ranks}
    elif task == "eval":
        from rebel_tpu_torch.eval.recursive_eval import run_eval_from_config

        result = run_eval_from_config(cfg, exp_dir, device=rt.device)
    else:
        raise ValueError(f"Unknown task: {task}")
    result["kernel_launches"] = kernel_launches(rt.world)
    distributed.shutdown()
    if rt.rank == 0:
        (exp_dir / "result.json").write_text(json.dumps(result, indent=1))
    log.info("Result: %s", json.dumps(result)[:2000])
    return Run(0, exp_dir, result, trainer)


def main(argv=None) -> int:
    return execute(argv).code


if __name__ == "__main__":
    sys.exit(main())
