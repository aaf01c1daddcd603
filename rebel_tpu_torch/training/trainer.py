"""Self-play trainer (CFR or fictitious-play subgames): generation,
learning, in-training exploitability and checkpoints on one card.

Counterpart of ``rebel_tpu/training/trainer.py``: :meth:`Trainer.run` on
one device, :meth:`Trainer.run_spmd` over the ranks of a process group
(:mod:`rebel_tpu_torch.parallel.mesh`).  Generation and learning share one
live net, so actors always use the learner's current weights, and the
replay ring never leaves the device.

Kept semantics:

* custom huber loss ``|x|>1 ? 2|x|-1 : x^2`` (or the squared error),
  mean over hands then batch;
* the optimizers ``adam``, ``sgd`` (momentum), ``radam`` and ``ralamb``
  with optax's update rules, behind optax's global-norm clip (scale by
  ``clip / norm`` when ``norm >= clip``; torch's ``clip_grad_norm_``
  divides by ``norm + 1e-6`` instead, so it is not used);
* lr 3e-4 halving every ``decrease_lr_every`` epochs at most
  ``decrease_lr_times`` times (a falsy count means unlimited halvings),
  applied per step;
* epoch = ``train_epoch_size / train_batch_size`` steps on uniform or
  prioritized replay samples;
* burn-in until the ring holds two batches, then train only while
  ``num_add * train_gen_ratio >= train_epoch_size * (epoch + 1)``;
* per-last-action loss buckets and the JAX package's metric names and
  definitions, written one line per epoch to ``metrics.jsonl``;
* validation snapshots of the ring (losses at checkpoint epochs), dataset
  dumps and preload in the reference binary format, purging, the
  ``benchmark_data_gen`` and ``fake_training`` modes, the stall watchdog;
* every ``checkpoint_every`` epochs a full-state checkpoint
  (``ckpt/epoch{N}.ckpt``: net, optimizer, step counts, replay ring,
  episodes, generator state; a resumed run continues the same stream) and
  a ``ckpt/epoch{N}.params`` export in the JAX package's format, which
  both packages' evaluations read;
* every ``exploit_every`` epochs the exploitability of the recursive
  strategy with the live net (``exploitability_last``), of the
  reach-weighted average of ``eval_num_repeats`` sampled strategies
  (``exploitability_avg``) and, with ``eval_mse``, the net's value errors.

Files are written only when ``out_dir`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
import pickle
import time

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets import convert
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.selfplay import replay as rb
from rebel_tpu_torch.selfplay.fast_runner import make_engine
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams
from rebel_tpu_torch.utils.watchdog import StallWatchdog

log = logging.getLogger(__name__)

# Epoch metrics the port writes beyond the JAX package's names: the parts
# of an exploit evaluation and the checkpoint write.
PORT_METRICS = ("timing/exploit_recursion", "timing/exploit_full_tree",
                "timing/exploit_sampled", "timing/exploit_mse",
                "timing/checkpoint", "checkpoint/bytes")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    env: RecursiveSolvingParams = RecursiveSolvingParams()
    # Model.
    n_hidden: int = 256
    n_layers: int = 2
    use_layer_norm: bool = True
    # Optimizer: 'adam' | 'sgd' | 'radam' | 'ralamb' (RAdam with LAMB's
    # per-tensor trust ratio); ``momentum`` is sgd's.
    lr: float = 3e-4
    decrease_lr_every: int = 400
    decrease_lr_times: int = 2
    grad_clip: float = 5.0
    loss: str = "huber"
    optimizer: str = "adam"
    momentum: float = 0.9
    # Data.
    train_epoch_size: int = 25600
    train_batch_size: int = 512
    replay_capacity: int = 2_000_000
    replay_alpha: float = 1.0
    replay_beta: float = 1.0
    use_priority: bool = False
    train_gen_ratio: int = 4
    max_epochs: int = 10000
    # Self-play engine: 'auto' (at depth 2 the fused solve, 'kernel', where
    # the JAX package's trainer takes 'fast'; else 'generic') | 'kernel'
    # ('pallas' in the JAX package's configs, which config.py maps) |
    # 'fast' | 'batched' | 'generic'.
    engine: str = "auto"
    # bfloat16: bf16 matmul operands with f32 accumulation and the fast
    # GELU inside the fused solve; float32 is the parity path.
    net_compute_dtype: torch.dtype = torch.float32
    selfplay_batch: int = 1024  # lockstep lanes
    gen_chunk_steps: int = 1  # engine steps per generation call
    seed: int = 0
    # Checkpoints: full-state files kept (the .params exports all are).
    checkpoint_every: int = 10
    keep_checkpoints: int = 3
    # Exit 87 with a STALLED file when no epoch completes for this long
    # (utils/watchdog.py); 0 = off.
    stall_timeout_s: float = 0.0
    exploit_every: int = 20
    exploit: bool = True
    eval_mse: bool = False
    eval_num_repeats: int = 8  # sampled strategies in exploitability_avg
    create_validation_set_every: int = 100
    validation_batches: int = 16
    train_preload: str | None = None  # a dataset file read before burn-in
    # benchmark_data_gen: generate for about this many seconds, log the
    # "BENCHMARK size ... speed ..." line and return without training;
    # fake_training: the whole epoch loop without the train steps.
    benchmark_data_gen: float = 0.0
    fake_training: bool = False
    dump_dataset_every_epochs: int = 0
    purging_epochs: tuple = ()
    purging_share_keep: float = 0.0
    solver_dtype: torch.dtype = torch.float32


def lr_schedule(cfg: TrainerConfig, steps_per_epoch: int):
    """``step -> lr``: at the start of epoch ``k * decrease_lr_every - 1``
    the lr halves, at most ``decrease_lr_times`` times."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        decays = (epoch + 1) // cfg.decrease_lr_every
        if cfg.decrease_lr_times:
            decays = min(decays, cfg.decrease_lr_times)
        return cfg.lr * 0.5**decays

    return schedule


def huber(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax > 1, ax * 2 - 1, x * x)


def last_action_index(queries: torch.Tensor, num_actions: int):
    """Index of the one-hot last action; ``num_actions`` for the initial
    state."""
    onehot = queries[:, 2:2 + num_actions]
    has = onehot.max(-1).values > 0.5
    return torch.where(has, onehot.argmax(-1), num_actions)


def bucket_metrics(game: LiarsDice, counts, loss_sums, val_sums) -> dict:
    """Per-last-action loss/value/share metrics from host sequences."""
    out = {}
    total = sum(counts)
    for a in range(game.num_actions + 1):
        name = "initial" if a == game.num_actions else a
        if counts[a] > 0:
            out[f"loss/train_{name}"] = loss_sums[a] / counts[a]
            out[f"val/train_{name}"] = val_sums[a] / counts[a]
        out[f"shares/train_{name}"] = counts[a] / total
    return out


# ------------------------------------------------------------ optimizers
class RAdam(torch.optim.Optimizer):
    """``radam``, and with ``trust_ratio`` ``ralamb``, with optax's update
    rules (``optax.radam``; ``scale_by_radam`` -> ``scale_by_trust_ratio``
    -> the lr), where torch's ``RAdam`` differs: the rectification is
    applied when ``rho_t >= threshold`` and otherwise the bias-corrected
    first moment is the update, ``eps`` is added outside the square root,
    and LAMB's trust ratio ``|param| / |update|`` is taken per parameter
    tensor (1 where either norm is 0).  The moments follow optax's
    expressions term for term; ``rho_t``, the rectification and the bias
    corrections are host scalars in float64.  Set ``lr`` in the param
    group before each step."""

    def __init__(self, params, lr: float = 1e-3, trust_ratio: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, trust_ratio=trust_ratio, b1=b1,
                                      b2=b2, eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                st["count"] += 1
                t = st["count"]
                u = st["mu"] / (1 - b1**t)
                b2t = b2**t
                ro = ro_inf - 2 * t * b2t / (1 - b2t)
                if ro >= group["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    u = r * u / (torch.sqrt(st["nu"] / (1 - b2t)) + eps)
                if group["trust_ratio"]:
                    p_norm, u_norm = p.norm(), u.norm()
                    u = u * torch.where((p_norm == 0) | (u_norm == 0), 1.0,
                                        p_norm / u_norm)
                p.add_(u * -group["lr"])


def make_optimizer(cfg: TrainerConfig, params) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optimizer`` over ``params``; its lr is set
    per step from :func:`lr_schedule`.  torch's ``Adam`` and ``SGD``
    (``dampening=0``: ``buf = g + momentum * buf``) compute optax's
    ``adam`` and ``sgd``; ``radam`` and ``ralamb`` are :class:`RAdam`."""
    name = cfg.optimizer.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               dampening=0.0)
    if name in ("radam", "ralamb"):
        return RAdam(params, lr=cfg.lr, trust_ratio=name == "ralamb")
    raise ValueError(f"Unknown optimizer: {cfg.optimizer!r}")


def engine_kind(cfg: TrainerConfig) -> str:
    """The :func:`~rebel_tpu_torch.selfplay.fast_runner.make_engine` kind
    of ``cfg.engine``: ``auto`` gives the fused solve at depth 2, else the
    generic engine."""
    if cfg.engine != "auto":
        return cfg.engine
    return "kernel" if cfg.env.subgame_params.max_depth == 2 else "generic"


# --------------------------------------------------------------- trainer
class Trainer:
    """Owns the net, optimizer, replay ring, episodes and generator.

    ``device`` defaults to the card; pass ``"cpu"`` to run the plain
    versions.  The engine comes from ``fast_runner.make_engine`` by
    :func:`engine_kind`; ``engine`` replaces it.  ``out_dir`` receives
    ``metrics.jsonl``, ``heartbeat``, checkpoints and dumps; ``None``
    writes nothing.  State is updated in place (the JAX package's
    immutable ``TrainState`` becomes attributes here)."""

    def __init__(self, cfg: TrainerConfig, device="cuda", engine=None,
                 out_dir: str | pathlib.Path | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.out_dir = None if out_dir is None else pathlib.Path(out_dir)
        self.game: LiarsDice = cfg.env.game
        self.engine = engine or make_engine(
            cfg.env, dtype=cfg.solver_dtype, kind=engine_kind(cfg),
            net_compute_dtype=cfg.net_compute_dtype)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.net = CFVNet(self.game, cfg.n_hidden, cfg.n_layers,
                          cfg.use_layer_norm, generator=init_gen
                          ).to(self.device)
        self.opt = make_optimizer(cfg, self.net.parameters())
        self.steps_per_epoch = cfg.train_epoch_size // cfg.train_batch_size
        self.schedule = lr_schedule(cfg, self.steps_per_epoch)
        self.gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.replay = rb.create(cfg.replay_capacity, self.game.query_size,
                                self.game.num_hands, self.device)
        self.episodes = EpisodeState.initial_batch(
            self.game, cfg.selfplay_batch, self.device, cfg.solver_dtype)
        self.epoch = 0
        self.step = 0
        self.gen_steps = 0
        self.burn_in_s = 0.0  # host seconds of the last run's burn-in
        self._eval_mse_broken = False

    def reset_optimizer(self) -> None:
        """A fresh optimizer over the net (step count 0)."""
        self.opt = make_optimizer(self.cfg, self.net.parameters())
        self.step = 0

    # ------------------------------------------------------------ steps
    def gen_chunk(self) -> torch.Tensor:
        """``gen_chunk_steps`` lockstep engine steps; each pushes
        ``2 * selfplay_batch`` examples with priority 1.  Returns the
        number of episodes that ended."""
        ended = 0
        for _ in range(self.cfg.gen_chunk_steps):
            eps, out = self.engine.batch_step(self.episodes, self.net,
                                              self.gen)
            self.episodes = eps
            rb.add(self.replay,
                   out.queries.reshape(-1, self.game.query_size),
                   out.values.reshape(-1, self.game.num_hands), 1.0,
                   self.cfg.replay_alpha)
            self.gen_steps += 1
            ended = ended + out.ended.sum()
        return ended

    def loss_fn(self, queries, targets):
        err = targets - self.net(queries)
        per_ex = (huber(err) if self.cfg.loss == "huber"
                  else err * err).mean(-1)
        return per_ex.mean(), per_ex

    def train_step(self, indices: torch.Tensor | None = None) -> dict:
        """One clipped optimizer step on a replay sample, prioritized with
        ``use_priority``, else uniform (``indices`` replaces the uniform
        draw).  Returns device tensors; nothing waits for the card."""
        cfg = self.cfg
        if cfg.use_priority and indices is None:
            sample = rb.sample_prioritized(self.replay, self.gen,
                                           cfg.train_batch_size,
                                           cfg.replay_beta)
        else:
            sample = rb.sample_uniform(self.replay, self.gen,
                                       cfg.train_batch_size, indices)
        loss, per_ex = self.loss_fn(sample.queries, sample.values)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        g_norm = self.clipped_step()
        return dict(loss=loss.detach(), g_norm=g_norm,
                    **self.bucket_sums(sample, per_ex))

    def clipped_step(self) -> torch.Tensor:
        """Optax's global-norm clip of the gradients in ``.grad``, then one
        optimizer step at the scheduled lr.  Returns the gradients' norm
        before the clip."""
        grads = [p.grad for p in self.net.parameters()]
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = g_norm < self.cfg.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * self.cfg.grad_clip))
        lr = self.schedule(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return g_norm.detach()

    def bucket_sums(self, sample: rb.Sample, per_ex: torch.Tensor) -> dict:
        """Per-last-action example counts, loss sums and value sums."""
        nb = self.game.num_actions + 1
        bucket = last_action_index(sample.queries, self.game.num_actions)
        z = lambda: torch.zeros(nb, device=self.device)
        return dict(
            counts=z().index_add_(0, bucket, torch.ones_like(per_ex)),
            loss_sums=z().index_add_(0, bucket, per_ex.detach()),
            val_sums=z().index_add_(0, bucket, sample.values.sum(-1)),
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _write_metrics(self, metrics: dict) -> None:
        if self.out_dir is not None:
            with open(self.out_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps(metrics) + "\n")

    # ------------------------------------------------------------ epochs
    def run(self, max_epochs: int | None = None) -> list[dict]:
        """Preload, burn-in, then epochs of throttled generation and
        training up to ``max_epochs``, with validation, dumps, purging,
        checkpoints and exploit evaluations at their cadences.  Returns
        one metrics dict per epoch (one benchmark dict with
        ``benchmark_data_gen``)."""
        cfg = self.cfg
        max_epochs = max_epochs or cfg.max_epochs
        batch = cfg.train_batch_size
        if self.out_dir is not None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        if cfg.train_preload and self.replay.num_add == 0:
            log.info("Preloading dataset from %s", cfg.train_preload)
            rb.load_into(self.replay, cfg.train_preload)
        # Throughput baselines: rows at entry (a preload or a resume) and
        # epochs run in this process.
        num_add_base = self.replay.num_add
        epoch_base = self.epoch

        if cfg.benchmark_data_gen:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < cfg.benchmark_data_gen:
                self.gen_chunk()
            self._sync()
            size = self.replay.num_add - num_add_base
            elapsed = time.perf_counter() - t0
            log.info("BENCHMARK size %s speed %.2f", size, size / elapsed)
            metrics = {"benchmark/examples": size,
                       "benchmark/examples_per_s": size / elapsed,
                       "benchmark/seconds": elapsed}
            self._write_metrics(metrics)
            return [metrics]

        t0 = time.perf_counter()
        while self.replay.size < 2 * batch:
            self.gen_chunk()
        self._sync()
        self.burn_in_s = time.perf_counter() - t0

        gen_time = train_time = 0.0
        val_sets = []
        all_metrics = []
        wd = StallWatchdog(cfg.stall_timeout_s, self.out_dir).start()
        try:
            for epoch in range(self.epoch, max_epochs):
                wd.alive(epoch)
                if (cfg.create_validation_set_every
                        and epoch % cfg.create_validation_set_every == 0):
                    s = rb.sample_uniform(self.replay, self.gen,
                                          cfg.validation_batches * batch)
                    val_sets.append((f"valid_snapshot_{epoch:04d}",
                                     s.queries, s.values))
                if (self.out_dir is not None and cfg.dump_dataset_every_epochs
                        and epoch % cfg.dump_dataset_every_epochs == 0):
                    dump_dir = self.out_dir / "dumped_data"
                    dump_dir.mkdir(parents=True, exist_ok=True)
                    rb.save(self.replay, dump_dir / f"data_{epoch:03d}.dat")

                t0 = time.perf_counter()
                while cfg.train_gen_ratio and (
                        self.replay.num_add * cfg.train_gen_ratio
                        < cfg.train_epoch_size * (epoch + 1)):
                    self.gen_chunk()
                self._sync()
                gen_time += time.perf_counter() - t0

                t0 = time.perf_counter()
                if cfg.fake_training:
                    self.epoch = epoch + 1
                    metrics = {"epoch": epoch,
                               "buffer/size": self.replay.size,
                               "buffer/added": self.replay.num_add}
                else:
                    stats = [self.train_step()
                             for _ in range(self.steps_per_epoch)]
                    self._sync()
                    self.epoch = epoch + 1
                    metrics = self._epoch_metrics(stats, epoch)
                    metrics["bps/train"] = self.steps_per_epoch / max(
                        time.perf_counter() - t0, 1e-9)
                    metrics["bps/train_examples"] = metrics["bps/train"] \
                        * batch
                train_time += time.perf_counter() - t0
                metrics["bps/gen"] = ((self.replay.num_add - num_add_base)
                                      / max(gen_time, 1e-9) / batch)
                metrics["bps/gen_examples"] = metrics["bps/gen"] * batch
                epochs_run = epoch - epoch_base + 1
                metrics["timing/gen"] = gen_time / epochs_run
                metrics["timing/train"] = train_time / epochs_run

                if cfg.purging_epochs and (epoch + 1) in cfg.purging_epochs:
                    rb.pop_until(self.replay, max(
                        2 * batch,
                        int(cfg.purging_share_keep * self.replay.size)))

                if epoch % cfg.checkpoint_every == 0:
                    for name, vq, vv in val_sets:
                        with torch.no_grad():
                            metrics[f"loss/{name}"] = float(
                                self.loss_fn(vq, vv)[0])
                    if self.out_dir is not None:
                        t0 = time.perf_counter()
                        metrics["checkpoint/bytes"] = \
                            self.save_checkpoint(epoch)
                        metrics["timing/checkpoint"] = \
                            time.perf_counter() - t0
                if (cfg.exploit and cfg.exploit_every
                        and epoch % cfg.exploit_every == 0):
                    t0 = time.perf_counter()
                    metrics.update(self.evaluate())
                    metrics["timing/exploit"] = time.perf_counter() - t0

                log.info(
                    "[Train] epoch %d loss %.6f exploit %s lr %.2e", epoch,
                    metrics.get("loss/train", float("nan")),
                    metrics.get("exploitability_avg",
                                metrics.get("exploitability_last", "-")),
                    metrics.get("optim/lr", float("nan")))
                self._write_metrics(metrics)
                all_metrics.append(metrics)
                if self.out_dir is not None:
                    # Liveness for the experiment-dir status: without it a
                    # healthy run reads DEAD after 300 s.
                    (self.out_dir / "heartbeat").touch()
        finally:
            wd.stop()
        return all_metrics

    # -------------------------------------------------- SPMD epoch loop
    def run_spmd(self, max_epochs: int | None = None, resume: bool = True,
                 hands: int = 1):
        """Epoch loop over the SPMD programs of
        :mod:`rebel_tpu_torch.parallel.mesh`: lanes and replay rows split
        over the data axis, gradients averaged, the net replicated.  Every
        rank runs this loop in lockstep, its control flow driven by
        replicated scalars (sums over the ranks, or rank 0's clock), and
        holds the net to every other rank's with ``torch.equal`` after
        each epoch (a difference raises).  The ranks form a grid of
        ``world // hands`` data ranks by ``hands`` hands ranks.

        Rank 0 alone writes: ``metrics.jsonl`` (with ``spmd/devices`` and
        ``spmd/processes``), ``heartbeat``, the in-training
        exploitability, and at checkpoint epochs ``ckpt/epoch<N>.spmd.ckpt``
        (net, optimizer, the gathered rings, episodes and every data
        rank's generator state, epoch, ``n_data``) and
        ``ckpt/epoch<N>.params``, each written under a temporary name
        and renamed, with ``keep_checkpoints`` retention of the state
        files.  With ``resume`` the newest state file is read: in full
        when its ``n_data`` is this grid's; otherwise the net and the
        optimizer only, with fresh rings and the generators seeded past
        the resume epoch.  Validation snapshots, dumps, preload, purging,
        ``benchmark_data_gen``, ``fake_training`` and the stall watchdog
        run here as in :meth:`run`.  Returns ``(state, metrics)``: this
        rank's :class:`~rebel_tpu_torch.parallel.mesh.SpmdState` and one
        dict per epoch."""
        from rebel_tpu_torch.parallel import mesh as meshlib
        from rebel_tpu_torch.parallel.distributed import (
            all_gather,
            broadcast_,
            group_size,
        )

        cfg = self.cfg
        layout = meshlib.make_layout(hands)
        init_state, gen_step, train_step = meshlib.make_spmd_programs(
            self, layout, hands=layout.n_hands > 1)
        n_data, master, dev = layout.n_data, layout.is_master, self.device
        log.info("[SPMD] rank %d of %d ranks, data x hands %d x %d%s",
                 layout.rank, layout.world, n_data, layout.n_hands,
                 f" (the hands axis splits num_hands={self.game.num_hands})"
                 if layout.n_hands > 1 else "")
        max_epochs = max_epochs or cfg.max_epochs
        out_dir = self.out_dir if master else None

        def total(key: str) -> int:
            """A ring count summed over the data axis."""
            return int(layout.data.psum_(
                torch.tensor([getattr(state.replay, key)])))

        def rank0_says(flag: bool) -> bool:
            return bool(broadcast_(torch.tensor([int(flag)]), 0))

        start_epoch, saved, ckpts = 0, None, []
        if resume and self.out_dir is not None:
            ckpts = spmd_checkpoints(self.out_dir / "ckpt")
            if ckpts:
                saved = torch.load(ckpts[-1], map_location="cpu",
                                   weights_only=True)
                start_epoch = int(saved["epoch"]) + 1
        # The rings and the generators are laid out per data rank, so a
        # full resume needs the checkpoint's data-axis size; otherwise the
        # rings restart empty and the streams are seeded past the resume
        # epoch (a resumed run must not replay epoch 0's episodes).
        full_resume = saved is not None and saved["n_data"] == n_data
        state = init_state(cfg.seed + (0 if full_resume else start_epoch))
        d = layout.data.index
        if saved is not None:
            self.net.load_state_dict(saved["net"])
            self.opt.load_state_dict(saved["optimizer"])
            self.step = int(saved["step"])
            if full_resume:
                lanes = state.episodes.root_bid.shape[0]
                state.episodes = EpisodeState(**{
                    k: v[d * lanes:(d + 1) * lanes].to(dev)
                    for k, v in saved["episodes"].items()})
                meshlib.ring_segment(saved["replay"], d, state.replay)
                self.gen_steps = int(saved["gen_steps"])
                if saved["generator_device"] == state.gen.device.type:
                    # A copy: set_state reads a view's storage from its
                    # start (row 1 of the stack crashes the process).
                    state.gen.set_state(saved["generators"][d].clone())
                else:
                    log.warning("run_spmd: the checkpoint's generators are %s "
                                "ones; reseeding past epoch %d",
                                saved["generator_device"], start_epoch)
                    state.gen.manual_seed(meshlib.rank_seed(
                        cfg.seed + start_epoch, d))
            else:
                log.warning(
                    "run_spmd: checkpoint was written on a %s-wide data "
                    "axis but the layout has %s; replay ring and episode "
                    "states restart empty", saved["n_data"], n_data)
            log.info("run_spmd: resumed from %s (epoch %d%s)", ckpts[-1],
                     start_epoch, ", full state" if full_resume
                     else ", params+opt only")
        # The trainer's own ring and lanes become this rank's.
        self.replay, self.episodes, self.gen = (state.replay, state.episodes,
                                                state.gen)
        self.epoch = start_epoch
        # With the rings restored, num_add counts the generation before
        # the resume, so the throttle's target counts from epoch 0; with
        # fresh rings it must not demand the earlier epochs' again.
        throttle_base = 0 if full_resume else start_epoch
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
        all_metrics, val_sets = [], []

        if cfg.train_preload and total("num_add") == 0:
            log.info("Preloading dataset from %s", cfg.train_preload)
            rows_q, rows_v = rb.load_file(cfg.train_preload)
            cap = state.replay.capacity
            base = {"queries": np.zeros((n_data * cap, self.game.query_size),
                                        np.float32),
                    "values": np.zeros((n_data * cap, self.game.num_hands),
                                       np.float32),
                    "priorities": np.zeros((n_data * cap,), np.float32)}
            meshlib.ring_segment(
                meshlib.rows_to_ring(base, rows_q, rows_v, n_data), d,
                state.replay)

        if cfg.benchmark_data_gen:
            added0 = total("num_add")
            t0 = time.perf_counter()
            while rank0_says(time.perf_counter() - t0
                             < cfg.benchmark_data_gen):
                gen_step(state)
            self._sync()
            size = total("num_add") - added0
            elapsed = time.perf_counter() - t0
            metrics = {"benchmark/examples": size,
                       "benchmark/examples_per_s": size / elapsed,
                       "benchmark/seconds": elapsed,
                       "spmd/devices": layout.world}
            if master:
                log.info("BENCHMARK size %s speed %.2f", size, size / elapsed)
                self._write_metrics(metrics)
            return state, [metrics]

        t0 = time.perf_counter()
        while total("num_add") < 4 * cfg.train_batch_size:
            gen_step(state)
        self._sync()
        self.burn_in_s = time.perf_counter() - t0

        wd = StallWatchdog(cfg.stall_timeout_s, out_dir,
                           what="spmd-train").start()
        try:
            for epoch in range(start_epoch, max_epochs):
                wd.alive(epoch)
                # Validation snapshots: the rings gathered, sampled with
                # the same seed on every rank.
                if (cfg.create_validation_set_every
                        and epoch % cfg.create_validation_set_every == 0):
                    rows_q, rows_v = meshlib.ring_valid_rows(
                        meshlib.gather_to_host(
                            layout.data, meshlib.ring_parts(state.replay)),
                        n_data)
                    if len(rows_q):
                        rng = np.random.default_rng(cfg.seed * 9973 + epoch)
                        idx = rng.integers(
                            0, len(rows_q),
                            cfg.validation_batches * cfg.train_batch_size)
                        val_sets.append((f"valid_snapshot_{epoch:04d}",
                                         rows_q[idx], rows_v[idx]))
                if (cfg.dump_dataset_every_epochs
                        and epoch % cfg.dump_dataset_every_epochs == 0):
                    host = meshlib.gather_to_host(
                        layout.data, meshlib.ring_parts(state.replay))
                    if out_dir is not None:
                        rows_q, rows_v = meshlib.ring_valid_rows(host, n_data)
                        dump_dir = out_dir / "dumped_data"
                        dump_dir.mkdir(parents=True, exist_ok=True)
                        n = len(rows_q)
                        rb.save(rb.Replay(torch.from_numpy(rows_q),
                                          torch.from_numpy(rows_v),
                                          torch.ones(n), 0, n, n),
                                dump_dir / f"data_{epoch:03d}.dat")

                t0 = time.perf_counter()
                while cfg.train_gen_ratio and (
                        total("num_add") * cfg.train_gen_ratio
                        < cfg.train_epoch_size * (epoch + 1 - throttle_base)):
                    gen_step(state)
                self._sync()
                gen_s = time.perf_counter() - t0

                t0 = time.perf_counter()
                stats = ([] if cfg.fake_training else
                         [train_step(state)
                          for _ in range(self.steps_per_epoch)])
                self._sync()
                train_s = time.perf_counter() - t0
                metrics = {"epoch": epoch, "buffer/added": total("num_add"),
                           "timing/gen": gen_s, "timing/train": train_s,
                           "spmd/devices": layout.world,
                           "spmd/processes": group_size()}
                if stats:
                    host = lambda k: torch.stack([s[k] for s in stats]).cpu()
                    g_norm = host("g_norm")
                    metrics.update({
                        "loss/train": float(host("loss").mean()),
                        "optim/lr": lr_schedule(cfg, 1)(epoch),
                        "optim/grad_max": float(g_norm.max()),
                        "optim/grad_mean": float(g_norm.mean())})
                    metrics.update(bucket_metrics(
                        self.game, host("counts").sum(0).tolist(),
                        host("loss_sums").sum(0).tolist(),
                        host("val_sums").sum(0).tolist()))
                if cfg.purging_epochs and (epoch + 1) in cfg.purging_epochs:
                    rb.pop_until(state.replay, max(
                        2 * (cfg.train_batch_size // n_data),
                        int(cfg.purging_share_keep * total("size"))
                        // n_data))
                # The net must be the same on every rank.
                every = all_gather(meshlib.flat_params(self.net)).view(
                    layout.world, -1)
                differ = [r for r in range(layout.world)
                          if not torch.equal(every[r], every[0])]
                if differ:
                    raise RuntimeError(f"epoch {epoch}: the net of ranks "
                                       f"{differ} differs from rank 0's")
                ckpt_epoch = epoch % cfg.checkpoint_every == 0
                if ckpt_epoch and self.out_dir is not None:
                    # Collectives: every rank joins, rank 0 writes.
                    t0 = time.perf_counter()
                    full = {
                        "episodes": meshlib.gather_to_host(
                            layout.data, state.episodes._asdict()),
                        "replay": meshlib.gather_to_host(
                            layout.data, meshlib.ring_parts(state.replay)),
                        "generators": layout.data.gather(
                            state.gen.get_state()[None], 0).cpu()}
                    if master:
                        metrics["checkpoint/bytes"] = \
                            self.save_spmd_checkpoint(epoch, n_data, full)
                        metrics["timing/checkpoint"] = \
                            time.perf_counter() - t0
                self.epoch = epoch + 1
                if master:
                    if (cfg.exploit and cfg.exploit_every
                            and epoch % cfg.exploit_every == 0):
                        # The other ranks wait at their next collective.
                        t0 = time.perf_counter()
                        metrics.update(self.evaluate_params(self.net))
                        metrics["timing/exploit"] = time.perf_counter() - t0
                    if ckpt_epoch:
                        for name, vq, vv in val_sets:
                            with torch.no_grad():
                                metrics[f"loss/{name}"] = float(self.loss_fn(
                                    torch.from_numpy(vq).to(dev),
                                    torch.from_numpy(vv).to(dev))[0])
                    log.info("[SPMD] epoch %d loss %.6f exploit %s (%d "
                             "devices, %d procs)", epoch,
                             metrics.get("loss/train", float("nan")),
                             metrics.get("exploitability_avg",
                                         metrics.get("exploitability_last",
                                                     "-")),
                             layout.world, group_size())
                    if out_dir is not None:
                        self._write_metrics(metrics)
                        (out_dir / "heartbeat").touch()
                log.info("[SPMD] rank %d epoch %d: net equal on all %d "
                         "ranks", layout.rank, epoch, layout.world)
                all_metrics.append(metrics)
        finally:
            wd.stop()
        return state, all_metrics

    def save_spmd_checkpoint(self, epoch: int, n_data: int,
                             full: dict) -> int:
        """``ckpt/epoch{epoch}.spmd.ckpt`` (the net, the optimizer, the
        gathered ``full`` state of the data ranks, ``n_data``) and
        ``ckpt/epoch{epoch}.params``, each renamed into place once
        written; prunes state files beyond ``keep_checkpoints``.  Returns
        the bytes written."""
        ckpt_dir = self.out_dir / "ckpt"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt, params = (ckpt_dir / f"epoch{epoch}.spmd.ckpt",
                        ckpt_dir / f"epoch{epoch}.params")
        tmp = ckpt_dir / f".epoch{epoch}.spmd.ckpt.tmp"
        torch.save({"epoch": epoch, "n_data": n_data, "step": self.step,
                    "gen_steps": self.gen_steps,
                    "net": self.net.state_dict(),
                    "optimizer": self.opt.state_dict(),
                    "generator_device": self.device.type, **full}, tmp)
        tmp.replace(ckpt)
        tmp = ckpt_dir / f".epoch{epoch}.params.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(convert.to_flax(self.net.state_dict()), f)
        tmp.replace(params)
        if self.cfg.keep_checkpoints:
            for old in spmd_checkpoints(ckpt_dir)[:-self.cfg.keep_checkpoints]:
                old.unlink()
        return ckpt.stat().st_size + params.stat().st_size

    def _epoch_metrics(self, stats: list[dict], epoch: int) -> dict:
        cfg = self.cfg
        host = lambda k: torch.stack([s[k] for s in stats]).cpu()
        g_norm = host("g_norm")
        metrics = {
            "epoch": epoch,
            "optim/lr": lr_schedule(cfg, 1)(epoch),
            "loss/train": float(host("loss").mean()),
            "optim/grad_max": float(g_norm.max()),
            "optim/grad_mean": float(g_norm.mean()),
            "optim/grad_clip_ratio": float(
                (g_norm >= cfg.grad_clip - 1e-5).float().mean()),
            "buffer/size": self.replay.size,
            "buffer/added": self.replay.num_add,
        }
        metrics.update(bucket_metrics(
            self.game, host("counts").sum(0).tolist(),
            host("loss_sums").sum(0).tolist(),
            host("val_sums").sum(0).tolist()))
        return metrics

    # ------------------------------------------------------------- eval
    def evaluate(self) -> dict:
        """In-training exploitability with the live net."""
        return self.evaluate_params(self.net)

    def evaluate_params(self, net: CFVNet) -> dict:
        """Exploitability of the recursive-to-leaf strategy with ``net``
        (computed in its own dtype, on queries in the solver's) in the
        solver's dtype (``exploitability_last``), of the
        reach-weighted average of ``eval_num_repeats`` sampled strategies
        (``exploitability_avg``; on the card in float32 through the fused
        solve with the MLP in float32, else the plain engine) and, with
        ``eval_mse``, the net's value errors (``eval_mse/net_reach``,
        ``eval_mse/fp_reach``; switched off for the rest of the run if
        they fail).  Also the host seconds of each part."""
        from rebel_tpu_torch.eval.recursive import (
            compute_strategy_recursive_to_leaf,
        )
        from rebel_tpu_torch.eval.recursive_eval import (
            full_solve,
            sampled_eval,
        )
        from rebel_tpu_torch.eval.stats import eval_net
        from rebel_tpu_torch.nets.value_nets import net_value_fn
        from rebel_tpu_torch.solving.exploitability import (
            compute_exploitability,
            full_tree_context,
        )

        sp = self.cfg.env.subgame_params
        dtype, dev = self.cfg.solver_dtype, self.device
        value_fn = net_value_fn(net)
        out = {}
        t0 = time.perf_counter()
        strategy = compute_strategy_recursive_to_leaf(
            self.game, sp, value_fn, dtype=dtype, device=dev)
        t1 = time.perf_counter()
        ctx = full_tree_context(self.game, dtype, dev)
        out["exploitability_last"] = compute_exploitability(ctx, strategy)
        out["timing/exploit_recursion"] = t1 - t0
        out["timing/exploit_full_tree"] = time.perf_counter() - t1
        if self.cfg.eval_num_repeats > 0:
            t0 = time.perf_counter()
            kernel = (dev.type == "cuda" and dtype == torch.float32
                      and sp.max_depth == 2)
            _, reports = sampled_eval(
                self.game, sp, value_fn, self.cfg.eval_num_repeats,
                full_strategy=None, mdp_depth=sp.max_depth, dtype=dtype,
                progress=False, engine="kernel" if kernel else "plain",
                net=net if kernel else None,
                net_compute_dtype=torch.float32 if kernel else None,
                device=dev)
            out["exploitability_avg"] = reports[-1]["exploitability"]
            out["timing/exploit_sampled"] = time.perf_counter() - t0
        if self.cfg.eval_mse and not self._eval_mse_broken:
            t0 = time.perf_counter()
            # A diagnostic must not take the run down with it.
            try:
                full_strategy, _, _ = full_solve(self.game, sp, dtype,
                                                 progress=False, device=dev)
                for name, by_net in (("net_reach", True),
                                     ("fp_reach", False)):
                    out[f"eval_mse/{name}"] = eval_net(
                        self.game, strategy, full_strategy,
                        mdp_depth=sp.max_depth, fp_iters=sp.num_iters,
                        value_fn=value_fn, traverse_by_net=by_net,
                        dtype=dtype, device=dev)
            except Exception:
                log.exception("eval_mse diagnostics failed; disabling for "
                              "the rest of this run")
                self._eval_mse_broken = True
            out["timing/exploit_mse"] = time.perf_counter() - t0
        return out

    # ------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        """The full training state; tensors stay where they are."""
        rp, ep = self.replay, self.episodes
        return {
            "epoch": self.epoch, "step": self.step,
            "gen_steps": self.gen_steps,
            "net": self.net.state_dict(),
            "optimizer": self.opt.state_dict(),
            "replay": {"queries": rp.queries, "values": rp.values,
                       "priorities": rp.priorities, "head": rp.head,
                       "size": rp.size, "num_add": rp.num_add},
            "episodes": ep._asdict(),
            "generator": self.gen.get_state(),
            "generator_device": self.gen.device.type,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place.  A generator
        state of another device type (a card checkpoint resumed on the
        CPU) cannot be restored: the stream is reseeded past the epoch,
        with a warning."""
        self.net.load_state_dict(state["net"])
        self.opt.load_state_dict(state["optimizer"])
        r = state["replay"]
        if r["queries"].shape != self.replay.queries.shape:
            raise ValueError(
                f"checkpoint replay ring {tuple(r['queries'].shape)} does "
                f"not match this config's {tuple(self.replay.queries.shape)}")
        for k in ("queries", "values", "priorities"):
            getattr(self.replay, k).copy_(r[k])
        self.replay.head, self.replay.size, self.replay.num_add = (
            int(r["head"]), int(r["size"]), int(r["num_add"]))
        self.episodes = EpisodeState(**{
            k: v.to(self.device) for k, v in state["episodes"].items()})
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self.gen_steps = int(state["gen_steps"])
        if state["generator_device"] == self.gen.device.type:
            self.gen.set_state(state["generator"].cpu())
        else:
            log.warning("checkpoint generator is a %s one; reseeding the "
                        "%s generator past epoch %d",
                        state["generator_device"], self.gen.device.type,
                        self.epoch)
            self.gen.manual_seed(self.cfg.seed + 1 + self.epoch)

    def save_checkpoint(self, epoch: int) -> int:
        """``ckpt/epoch{epoch}.ckpt`` (full state, ``torch.save``) and
        ``ckpt/epoch{epoch}.params`` (a pickle of the net's flax parameter
        tree of numpy arrays, the JAX package's export format), each
        written to a temporary name and then renamed, so that a kill
        mid-write leaves no truncated newest file; prunes full-state files
        beyond ``keep_checkpoints``.  Returns the bytes written."""
        ckpt_dir = self.out_dir / "ckpt"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt, params = (ckpt_dir / f"epoch{epoch}.ckpt",
                        ckpt_dir / f"epoch{epoch}.params")
        tmp = ckpt_dir / f".epoch{epoch}.ckpt.tmp"
        torch.save(self.state_dict(), tmp)
        tmp.replace(ckpt)
        tmp = ckpt_dir / f".epoch{epoch}.params.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(convert.to_flax(self.net.state_dict()), f)
        tmp.replace(params)
        if self.cfg.keep_checkpoints:
            for old in checkpoints(ckpt_dir)[:-self.cfg.keep_checkpoints]:
                old.unlink()
        return ckpt.stat().st_size + params.stat().st_size

    def load_checkpoint(self, path) -> None:
        """Resume from a :meth:`save_checkpoint` file (in place)."""
        self.load_state_dict(torch.load(path, map_location=self.device,
                                        weights_only=True))


def checkpoints(ckpt_dir: pathlib.Path) -> list[pathlib.Path]:
    """Full-state checkpoints ``epoch<N>.ckpt`` in ``ckpt_dir``, oldest
    first."""
    if not ckpt_dir.exists():
        return []
    return sorted((p for p in ckpt_dir.glob("epoch*.ckpt")
                   if p.stem[5:].isdigit()), key=lambda p: int(p.stem[5:]))


def spmd_checkpoints(ckpt_dir: pathlib.Path) -> list[pathlib.Path]:
    """SPMD state files ``epoch<N>.spmd.ckpt`` in ``ckpt_dir``, oldest
    first."""
    if not ckpt_dir.exists():
        return []
    found = [(p.name[5:-len(".spmd.ckpt")], p)
             for p in ckpt_dir.glob("epoch*.spmd.ckpt")]
    return [p for _, p in sorted((int(n), p) for n, p in found
                                 if n.isdigit())]


def load_params(path, game: LiarsDice, device="cuda") -> CFVNet:
    """The net of a ``.params`` export (either package's)."""
    return convert.load_params_net(path, game, device)
