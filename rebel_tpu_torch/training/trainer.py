"""Self-play trainer (CFR or fictitious-play subgames): generation and
learning on one card.

Counterpart of ``rebel_tpu/training/trainer.py`` (single-process path).
Generation and learning share one live net, so actors always use the
learner's current weights, and the replay ring never leaves the device.

Kept semantics:

* custom huber loss ``|x|>1 ? 2|x|-1 : x^2``, mean over hands then batch;
* Adam, lr 3e-4, global-norm clip 5.0 with optax's rule (scale by
  ``clip / norm`` when ``norm >= clip``; torch's ``clip_grad_norm_``
  divides by ``norm + 1e-6`` instead, so it is not used);
* lr halves every ``decrease_lr_every`` epochs at most
  ``decrease_lr_times`` times (a falsy count means unlimited halvings);
* epoch = ``train_epoch_size / train_batch_size`` steps;
* burn-in until the ring holds two batches, then train only while
  ``num_add * train_gen_ratio >= train_epoch_size * (epoch + 1)``;
* per-last-action loss buckets.

The config is built in code (no yaml needed on the card).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.selfplay import replay as rb
from rebel_tpu_torch.selfplay.fast_runner import FastCudaEngine
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    env: RecursiveSolvingParams = RecursiveSolvingParams()
    n_hidden: int = 256
    n_layers: int = 2
    use_layer_norm: bool = True
    lr: float = 3e-4
    decrease_lr_every: int = 400
    decrease_lr_times: int = 2
    grad_clip: float = 5.0
    train_epoch_size: int = 25600
    train_batch_size: int = 512
    replay_capacity: int = 2_000_000
    train_gen_ratio: int = 4
    max_epochs: int = 10000
    selfplay_batch: int = 1024
    # bfloat16: bf16 matmul operands with f32 accumulation and the fast
    # GELU inside the solve; float32 is the parity path.
    net_compute_dtype: torch.dtype = torch.float32
    seed: int = 0


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


class Trainer:
    """Owns the net, optimizer, replay ring, episodes and generators.

    ``device`` defaults to the card; pass ``"cpu"`` to run the plain
    versions.  ``engine`` replaces the default :class:`FastCudaEngine`.
    State is updated in place (the reference's immutable ``TrainState``
    becomes attributes here)."""

    def __init__(self, cfg: TrainerConfig, device="cuda", engine=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        self.game: LiarsDice = cfg.env.game
        self.engine = engine or FastCudaEngine(
            cfg=cfg.env, net_compute_dtype=cfg.net_compute_dtype)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.net = CFVNet(self.game, cfg.n_hidden, cfg.n_layers,
                          cfg.use_layer_norm, generator=init_gen
                          ).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=cfg.lr,
                                    eps=1e-8)
        self.steps_per_epoch = cfg.train_epoch_size // cfg.train_batch_size
        self.schedule = lr_schedule(cfg, self.steps_per_epoch)
        self.gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.replay = rb.create(cfg.replay_capacity, self.game.query_size,
                                self.game.num_hands, self.device)
        self.episodes = EpisodeState.initial_batch(
            self.game, cfg.selfplay_batch, self.device
        )
        self.epoch = 0
        self.step = 0
        self.gen_steps = 0

    # ------------------------------------------------------------ steps
    def gen_chunk(self) -> torch.Tensor:
        """One lockstep engine step; pushes ``2 * selfplay_batch``
        examples.  Returns the number of episodes that ended."""
        eps, out = self.engine.batch_step(self.episodes, self.net, self.gen)
        self.episodes = eps
        rb.add(self.replay, out.queries.reshape(-1, self.game.query_size),
               out.values.reshape(-1, self.game.num_hands))
        self.gen_steps += 1
        return out.ended.sum()

    def loss_fn(self, queries, targets):
        per_ex = huber(targets - self.net(queries)).mean(-1)
        return per_ex.mean(), per_ex

    def train_step(self, indices: torch.Tensor | None = None) -> dict:
        """One Adam step on a uniform replay sample (``indices`` replaces
        the draw).  Returns device tensors; nothing waits for the card."""
        cfg = self.cfg
        sample = rb.sample_uniform(self.replay, self.gen,
                                   cfg.train_batch_size, indices)
        loss, per_ex = self.loss_fn(sample.queries, sample.values)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in self.net.parameters()]
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = g_norm < cfg.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * cfg.grad_clip))
        lr = self.schedule(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        nb = self.game.num_actions + 1
        bucket = last_action_index(sample.queries, self.game.num_actions)
        z = lambda: torch.zeros(nb, device=self.device)
        return dict(
            loss=loss.detach(),
            g_norm=g_norm.detach(),
            lr=lr,
            counts=z().index_add_(0, bucket, torch.ones_like(per_ex)),
            loss_sums=z().index_add_(0, bucket, per_ex.detach()),
            val_sums=z().index_add_(0, bucket, sample.values.sum(-1)),
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ epochs
    def run(self, max_epochs: int | None = None) -> list[dict]:
        """Burn-in, then epochs of throttled generation and training, up
        to ``max_epochs``.  Returns one metrics dict per epoch."""
        cfg = self.cfg
        max_epochs = max_epochs or cfg.max_epochs
        batch = cfg.train_batch_size
        all_metrics = []
        t0 = time.perf_counter()
        while self.replay.size < 2 * batch:
            self.gen_chunk()
        self._sync()
        burn_in_s = time.perf_counter() - t0
        for epoch in range(self.epoch, max_epochs):
            t0 = time.perf_counter()
            gens0 = self.gen_steps
            while cfg.train_gen_ratio and (
                self.replay.num_add * cfg.train_gen_ratio
                < cfg.train_epoch_size * (epoch + 1)
            ):
                self.gen_chunk()
            self._sync()
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            stats = [self.train_step() for _ in range(self.steps_per_epoch)]
            self._sync()
            train_s = time.perf_counter() - t0
            self.epoch = epoch + 1
            host = lambda k: torch.stack([s[k] for s in stats]).cpu()
            counts = host("counts").sum(0).tolist()
            loss_sums = host("loss_sums").sum(0).tolist()
            val_sums = host("val_sums").sum(0).tolist()
            g_norm = host("g_norm")
            metrics = {
                "epoch": epoch,
                "loss/train": float(host("loss").mean()),
                "optim/lr": stats[-1]["lr"],
                "optim/grad_max": float(g_norm.max()),
                "optim/grad_mean": float(g_norm.mean()),
                "optim/grad_clip_ratio": float(
                    (g_norm > cfg.grad_clip).float().mean()),
                "buffer/size": self.replay.size,
                "buffer/added": self.replay.num_add,
                "gen/steps": self.gen_steps - gens0,
                "gen/examples": 2 * cfg.selfplay_batch
                * (self.gen_steps - gens0),
                "timing/burn_in": burn_in_s if epoch == 0 else 0.0,
                "timing/gen": gen_s,
                "timing/train": train_s,
                "bps/train": self.steps_per_epoch / max(train_s, 1e-9),
            }
            metrics.update(bucket_metrics(self.game, counts, loss_sums,
                                          val_sums))
            all_metrics.append(metrics)
        return all_metrics
