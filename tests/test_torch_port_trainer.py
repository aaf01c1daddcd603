"""The port's replay ring and trainer against the JAX trainer on the CPU.

``jax.random`` and ``torch.Generator`` give different numbers, so the
JAX trainer's random draws (replay rows, stop iterations, actions) are
recomputed from its own keys and handed to the port.  Parameters must
agree at 1e-5 after the same Adam steps on the same rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu.selfplay import replay as jrb
from rebel_tpu.selfplay.fast_runner import FastPallasEngine
from rebel_tpu.training.trainer import Trainer as JTrainer
from rebel_tpu.training.trainer import TrainerConfig as JTrainerConfig
from rebel_tpu.training.trainer import huber as jhuber
from rebel_tpu.training.trainer import last_action_index as jlast_action
from rebel_tpu.training.trainer import lr_schedule as jlr_schedule

from rebel_tpu_torch.nets.convert import from_flax, to_flax
from rebel_tpu_torch.selfplay import replay as rb
from rebel_tpu_torch.selfplay.fast_runner import advance
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
    huber,
    last_action_index,
    lr_schedule,
)

from test_torch_port_selfplay import _cfgs, _jax_draws, _to_port

f32 = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _configs(**kw):
    jcfg, cfg = _cfgs()
    common = dict(n_hidden=16, n_layers=2, train_batch_size=8,
                  train_epoch_size=32, train_gen_ratio=1, replay_capacity=64,
                  selfplay_batch=8, seed=3, exploit=False,
                  create_validation_set_every=0, **kw)
    jt = JTrainerConfig(env=jcfg, engine="pallas", **common)
    return jt, TrainerConfig(env=cfg, **common)


def _jax_indices(replay, key, n, batch):
    """The rows ``Trainer._train_chunk`` samples: ``n`` keys split from
    ``key``, each drawing offsets below the ring's newest row."""
    out = []
    for k in jax.random.split(key, n):
        off = jax.random.randint(k, (batch,), 0, max(int(replay.size), 1))
        out.append(np.array((int(replay.head) - 1 - off) % replay.capacity))
    return out


def _assert_params(net, params, atol):
    port = to_flax(net.state_dict())
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(f32(params))):
        np.testing.assert_allclose(a, b, atol=atol)


def test_replay_add_wraps_and_samples_injected_rows():
    rng = np.random.RandomState(0)
    C, Q, H = 10, 5, 3
    j = jrb.create(C, Q, H)
    p = rb.create(C, Q, H, device="cpu")
    for k in (4, 7, 13):  # the last write is larger than the ring
        q = rng.randn(k, Q).astype(np.float32)
        v = rng.randn(k, H).astype(np.float32)
        j = jrb.add(j, jnp.asarray(q), jnp.asarray(v))
        rb.add(p, torch.as_tensor(q), torch.as_tensor(v))
        assert (p.head, p.size, p.num_add) == (
            int(j.head), int(j.size), int(j.num_add))
        np.testing.assert_array_equal(p.queries.numpy(), np.asarray(j.queries))
        np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
    key = jax.random.PRNGKey(5)
    js = jrb.sample_uniform(j, key, 6)
    s = rb.sample_uniform(p, None, 6, indices=torch.as_tensor(
        np.array(js.indices)))
    np.testing.assert_array_equal(s.queries.numpy(), np.asarray(js.queries))
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(js.values))
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(js.indices))
    drawn = rb.sample_uniform(p, torch.Generator().manual_seed(0), 4000)
    assert drawn.indices.unique().numel() == C  # every valid row reachable


def test_loss_schedule_and_buckets_equal_jax():
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_array_equal(huber(torch.as_tensor(x)).numpy(),
                                  np.asarray(jhuber(jnp.asarray(x))))
    for times in (2, 0):
        jcfg, cfg = _configs(decrease_lr_every=3, decrease_lr_times=times)
        js, s = jlr_schedule(jcfg, 5), lr_schedule(cfg, 5)
        for step in range(0, 80, 4):
            assert s(step) == pytest.approx(float(js(step)), rel=1e-12)
    q = np.zeros((4, 2 + 9 + 8), np.float32)
    q[0, 2 + 3] = q[1, 2 + 8] = q[3, 2] = 1.0
    np.testing.assert_array_equal(
        last_action_index(torch.as_tensor(q), 9).numpy(),
        np.asarray(jlast_action(jnp.asarray(q), 9)))


@pytest.mark.parametrize("grad_clip", [5.0, 1e-3], ids=["clip5", "clipping"])
def test_train_steps_match_jax(grad_clip):
    """Three Adam steps with global-norm clipping (optax's rule) on the
    same replay rows: parameters at 1e-5."""
    jcfg, cfg = _configs(grad_clip=grad_clip)
    jt = JTrainer(jcfg)
    state = jt.init_state()
    rng = np.random.RandomState(1)
    q = rng.rand(40, jt.game.query_size).astype(np.float32)
    v = rng.randn(40, jt.game.num_hands).astype(np.float32)
    jrep = jrb.add(state.replay, jnp.asarray(q), jnp.asarray(v))
    key = jax.random.PRNGKey(9)
    params, _, stats = jt._train_chunk(state.params, state.opt_state, jrep,
                                       key, 3)

    tr = Trainer(cfg, device="cpu")
    tr.net.load_state_dict(from_flax(f32(state.params)))
    rb.add(tr.replay, torch.as_tensor(q), torch.as_tensor(v))
    out = [tr.train_step(torch.as_tensor(i))
           for i in _jax_indices(jrep, key, 3, cfg.train_batch_size)]
    _assert_params(tr.net, params, 1e-5)
    for name in ("loss", "g_norm"):
        np.testing.assert_allclose([float(o[name]) for o in out],
                                   np.asarray(stats[name]), rtol=1e-5)
    for name in ("counts", "loss_sums", "val_sums"):
        np.testing.assert_allclose(torch.stack([o[name] for o in out]),
                                   np.asarray(stats[name]), atol=1e-5)


def test_trainer_slice_matches_jax_trainer(tmp_path):
    """Burn-in, one throttled generation step and one epoch of four train
    steps: the JAX trainer on ``FastPallasEngine`` (interpret mode) and
    the port's trainer with the JAX draws injected must leave the same
    replay, episodes and parameters."""
    jcfg, cfg = _configs()
    B = cfg.selfplay_batch
    jt = JTrainer(jcfg, out_dir=tmp_path)
    jt.engine = FastPallasEngine(cfg=jcfg.env, dtype=jnp.float32,
                                 lane_block=B, interpret=True)
    jt._build_programs()
    state0 = jt.init_state()
    jstate, jmetrics = jt.run(state0, max_epochs=1)

    # The JAX trainer's draws, from its key schedule (Trainer._gen and
    # the epoch loop's key split) and the episodes its engine walked.
    params = f32(state0.params)
    key, ep_j = state0.key, state0.episodes
    draws = []
    for _ in range(2):  # burn-in, then one throttled generation step
        key, k = jax.random.split(key)
        lane_keys = jax.random.split(jax.random.split(k, 1)[0], B)
        draws.append(_jax_draws(jcfg.env, ep_j, lane_keys, params, B))
        ep_j, _ = jt.engine.batch_step(ep_j, lane_keys, params)
    key, k_train = jax.random.split(key)

    class InjectedEngine:
        def __init__(self):
            self.draws = iter(draws)

        def batch_step(self, eps, net, gen):
            t, a1, a2 = (torch.as_tensor(np.array(x)).long()
                         for x in next(self.draws))
            sol = grid2p.solve(cfg.env.game, cfg.env.subgame_params,
                               eps.root_bid, eps.root_player, eps.beliefs,
                               t, net)
            return advance(cfg.env, eps, sol.snap0, sol.snap1, sol.rvm,
                           a1, a2)

    class InjectedTrainer(Trainer):
        def train_step(self, indices=None):
            if self.step == 0:
                self.rows = iter(_jax_indices(self.replay, k_train,
                                              self.steps_per_epoch,
                                              cfg.train_batch_size))
            return super().train_step(torch.as_tensor(next(self.rows)))

    tr = InjectedTrainer(cfg, device="cpu", engine=InjectedEngine())
    tr.net.load_state_dict(from_flax(params))
    metrics = tr.run(max_epochs=1)

    assert tr.gen_steps == 2 and tr.replay.num_add == int(
        jstate.replay.num_add) == 4 * B
    n = tr.replay.size
    np.testing.assert_allclose(tr.replay.queries[:n].numpy(),
                               np.asarray(jstate.replay.queries)[:n],
                               atol=1e-6)
    np.testing.assert_allclose(tr.replay.values[:n].numpy(),
                               np.asarray(jstate.replay.values)[:n],
                               atol=2e-5)
    new = _to_port(jstate.episodes)
    assert torch.equal(tr.episodes.root_bid, new.root_bid)
    assert torch.equal(tr.episodes.root_player, new.root_player)
    np.testing.assert_allclose(tr.episodes.beliefs.numpy(),
                               new.beliefs.numpy(), atol=2e-5)
    _assert_params(tr.net, jstate.params, 1e-5)
    assert metrics[0]["loss/train"] == pytest.approx(
        jmetrics[0]["loss/train"], rel=1e-5)


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("name", ["adam", "sgd", "radam", "ralamb"])
def test_optimizers_match_optax(name):
    """25 steps of a fixed gradient sequence (large and small, so RAdam
    crosses its rectification threshold) with a changing lr, from a
    parameter tree with a zero tensor (LAMB's trust ratio is 1 there):
    float32 parameters at 1e-6."""
    import optax

    from rebel_tpu.training.trainer import _make_optimizer
    from rebel_tpu_torch.training.trainer import make_optimizer

    rng = np.random.RandomState(4)
    init = {"w": rng.randn(6, 5).astype(np.float32),
            "b": np.zeros(5, np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-3, 2)).astype(
        np.float32) for k, v in init.items()} for _ in range(25)]
    lrs = [1e-3 * 0.5 ** (i // 10) for i in range(25)]
    jcfg, cfg = _configs(optimizer=name)
    opt = _make_optimizer(jcfg, lambda count: jnp.asarray(lrs)[count])
    jp = jax.tree.map(jnp.asarray, init)
    state = opt.init(jp)
    params = [torch.nn.Parameter(torch.as_tensor(init[k].copy()))
              for k in ("w", "b")]
    topt = make_optimizer(cfg, params)
    for g, lr in zip(grads, lrs):
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(params, ("w", "b")):
            p.grad = torch.as_tensor(g[k])
        for group in topt.param_groups:
            group["lr"] = lr
        topt.step()
    for p, k in zip(params, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(_configs(optimizer="lion")[1], params)


# ----------------------------------------- the epoch loop and the eval
def _small(use_cfr=False, **kw):
    """1x3, 16 iterations, a 32x1 net, float64 solver, in both packages."""
    from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRSP
    from rebel_tpu.solving.params import SubgameSolvingParams as JParams
    from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
    from rebel_tpu_torch.solving.params import SubgameSolvingParams

    sub = dict(num_iters=16, max_depth=2, linear_update=True, use_cfr=use_cfr)
    env = dict(num_dice=1, num_faces=3, random_action_prob=0.25,
               sample_leaf=True)
    common = dict(n_hidden=32, n_layers=1, train_epoch_size=64,
                  train_batch_size=16, replay_capacity=512, selfplay_batch=8,
                  max_epochs=1, checkpoint_every=1,
                  create_validation_set_every=1, exploit_every=1,
                  eval_mse=True, eval_num_repeats=2)
    common.update(kw)
    return (JTrainerConfig(env=JRSP(subgame_params=JParams(**sub), **env),
                           solver_dtype=jnp.float64, **common),
            TrainerConfig(env=RecursiveSolvingParams(
                subgame_params=SubgameSolvingParams(**sub), **env),
                solver_dtype=torch.float64, **common))


def test_epoch_metrics_and_evaluation_equal_jax(tmp_path):
    """One epoch with validation, checkpoint and exploit evaluation in
    each package: the same metric names (the port adds the parts of the
    evaluation and the checkpoint write; the per-action loss and value
    names depend on the rows drawn).  The JAX package's ``epoch0.params``
    evaluated by the port's ``evaluate_params`` gives the JAX metrics
    (FP, float64 solver) at 1e-8; the port's ``.params`` loads through the
    JAX package's loaders to the port net's outputs at 1e-6."""
    from rebel_tpu.eval.recursive_eval import _load_net
    from rebel_tpu.training.trainer import load_params as jload_params
    from rebel_tpu_torch.training.trainer import PORT_METRICS, load_params

    jcfg, cfg = _small()
    _, (jm,) = JTrainer(jcfg, out_dir=tmp_path / "jax").run()
    tr = Trainer(cfg, device="cpu", out_dir=tmp_path / "port")
    (m,) = tr.run()
    per_action = lambda keys: {k for k in keys
                               if k.startswith(("loss/train_", "val/train_"))}
    assert set(m) - per_action(m) - set(PORT_METRICS) == \
        set(jm) - per_action(jm)
    assert set(PORT_METRICS) <= set(m)
    assert per_action(m) <= {f"{p}/train_{a}" for p in ("loss", "val")
                             for a in [*range(tr.game.num_actions), "initial"]}
    for k, v in m.items():
        assert np.isfinite(v), k

    net = load_params(tmp_path / "jax" / "ckpt" / "epoch0.params", tr.game,
                      "cpu")
    got = tr.evaluate_params(net)
    for k in ("exploitability_last", "exploitability_avg",
              "eval_mse/net_reach", "eval_mse/fp_reach"):
        assert abs(got[k] - jm[k]) < 1e-8, (k, got[k], jm[k])

    path = tmp_path / "port" / "ckpt" / "epoch0.params"
    q = np.random.RandomState(0).rand(64, tr.game.query_size).astype(
        np.float32)
    want = tr.net(torch.as_tensor(q)).detach().numpy()
    jvf, _ = _load_net(str(path), JTrainer(jcfg).game, {"model": {
        "kwargs": {"n_hidden": 32, "n_layers": 1}}})
    np.testing.assert_allclose(np.asarray(jvf(jnp.asarray(q))), want,
                               atol=1e-6)
    jparams = jload_params(str(path))["params"]
    assert jparams["Dense_0"]["kernel"].shape == (tr.game.query_size, 32)
    assert jparams["Dense_1"]["kernel"].shape == (32, tr.game.num_hands)


def test_resume_equals_uninterrupted(tmp_path):
    """Two epochs, a checkpoint, a fresh trainer loading it and a third
    epoch: the same parameters, optimizer moments, replay ring, episodes
    and generator as three straight epochs (``torch.equal``).  Validation
    snapshots draw from the generator every epoch, so its state must
    carry over too."""
    _, cfg = _small(use_cfr=True, exploit=False, max_epochs=3,
                    use_priority=True)
    cfg = dataclasses.replace(cfg, solver_dtype=torch.float32)
    straight = Trainer(cfg, device="cpu", out_dir=tmp_path / "a")
    straight.run()
    first = Trainer(cfg, device="cpu", out_dir=tmp_path / "b")
    first.run(max_epochs=2)
    resumed = Trainer(cfg, device="cpu", out_dir=tmp_path / "c")
    resumed.load_checkpoint(tmp_path / "b" / "ckpt" / "epoch1.ckpt")
    assert (resumed.epoch, resumed.step) == (2, 2 * resumed.steps_per_epoch)
    (m,) = resumed.run()
    assert m["epoch"] == 2
    a, b = straight.state_dict(), resumed.state_dict()
    for k in ("epoch", "step", "gen_steps"):
        assert a[k] == b[k], k
    for x, y in zip(jax.tree.leaves(a["net"]), jax.tree.leaves(b["net"])):
        assert torch.equal(x, y)
    for p, q in zip(straight.opt.state.values(), resumed.opt.state.values()):
        assert p.keys() == q.keys()
        assert all(torch.equal(p[k], q[k]) for k in p)
    for k in ("queries", "values", "priorities", "head", "size", "num_add"):
        x, y = a["replay"][k], b["replay"][k]
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y, k
    for k in a["episodes"]:
        assert torch.equal(a["episodes"][k], b["episodes"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    # Retention keeps the newest keep_checkpoints full-state files.
    keep = dataclasses.replace(cfg, keep_checkpoints=2, max_epochs=3)
    Trainer(keep, device="cpu", out_dir=tmp_path / "d").run()
    assert sorted(p.name for p in (tmp_path / "d" / "ckpt").iterdir()) == [
        "epoch0.params", "epoch1.ckpt", "epoch1.params", "epoch2.ckpt",
        "epoch2.params"]


def test_benchmark_and_fake_training_modes(tmp_path):
    _, cfg = _small(exploit=False, create_validation_set_every=0)
    bench = Trainer(dataclasses.replace(cfg, benchmark_data_gen=0.3),
                    device="cpu", out_dir=tmp_path / "bench")
    fresh = Trainer(cfg, device="cpu")
    (m,) = bench.run()
    assert m["benchmark/examples"] > 0 and m["benchmark/examples_per_s"] > 0
    assert bench.epoch == 0 and bench.step == 0
    for x, y in zip(bench.net.parameters(), fresh.net.parameters()):
        assert torch.equal(x, y)
    assert (tmp_path / "bench" / "metrics.jsonl").exists()
    fake = Trainer(dataclasses.replace(cfg, fake_training=True,
                                       max_epochs=3), device="cpu")
    metrics = fake.run()
    assert len(metrics) == 3 and "loss/train" not in metrics[-1]
    assert metrics[-1]["bps/gen_examples"] > 0
    assert metrics[-1]["buffer/added"] >= 64 * 3 // 4  # the throttle ran
    for x, y in zip(fake.net.parameters(), fresh.net.parameters()):
        assert torch.equal(x, y)


def test_validation_dump_preload_and_purge(tmp_path):
    """Validation losses at checkpoint epochs, a dataset dump that the JAX
    package reads, a purge at its epoch, and a new trainer preloaded from
    the dump."""
    from rebel_tpu.selfplay import replay as jrb_

    _, cfg = _small(exploit=False, max_epochs=3, checkpoint_every=2,
                    dump_dataset_every_epochs=2, purging_epochs=(2,),
                    purging_share_keep=0.5)
    tr = Trainer(cfg, device="cpu", out_dir=tmp_path)
    metrics = tr.run()
    assert {k for k in metrics[2] if k.startswith("loss/valid")} == {
        "loss/valid_snapshot_0000", "loss/valid_snapshot_0001",
        "loss/valid_snapshot_0002"}
    assert not any(k.startswith("loss/valid") for k in metrics[1])
    # Purged after epoch 1 (epoch + 1 == 2) to half the ring, at least two
    # batches; the dump at the start of epoch 2 holds what was kept.
    dump = tmp_path / "dumped_data" / "data_002.dat"
    q, v = jrb_.load_file(str(dump))
    assert q.shape == (max(32, metrics[1]["buffer/size"] // 2),
                       tr.game.query_size)
    assert (tmp_path / "dumped_data" / "data_000.dat").exists()
    pre = Trainer(dataclasses.replace(cfg, train_preload=str(dump),
                                      train_gen_ratio=0, max_epochs=1,
                                      purging_epochs=()), device="cpu")
    (m,) = pre.run()
    assert m["buffer/added"] == len(q) and np.isfinite(m["loss/train"])
    np.testing.assert_array_equal(rb.extract(pre.replay)[0], q)


def test_engine_kinds():
    from rebel_tpu_torch.selfplay.fast_runner import (
        FastBatchedEngine,
        FastCudaEngine,
        FastSelfPlayEngine,
    )
    from rebel_tpu_torch.selfplay.runner import SelfPlayEngine

    _, cfg = _small()
    kind = lambda **kw: type(Trainer(dataclasses.replace(cfg, **kw),
                                     device="cpu").engine)
    for name in ("auto", "kernel"):
        assert kind(engine=name) is FastCudaEngine
    assert kind(engine="batched") is FastBatchedEngine
    assert kind(engine="generic") is SelfPlayEngine
    deep = dataclasses.replace(cfg.env, subgame_params=dataclasses.replace(
        cfg.env.subgame_params, max_depth=3))
    assert kind(env=deep) is SelfPlayEngine
    assert kind(engine="fast") is FastSelfPlayEngine
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, device="cuda")
