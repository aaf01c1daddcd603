"""The port's replay ring and trainer against the JAX trainer on the CPU.

``jax.random`` and ``torch.Generator`` give different numbers, so the
JAX trainer's random draws (replay rows, stop iterations, actions) are
recomputed from its own keys and handed to the port.  Parameters must
agree at 1e-5 after the same Adam steps on the same rows.
"""

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
                  selfplay_batch=8, seed=3, **kw)
    jt = JTrainerConfig(env=jcfg, engine="pallas", exploit=False,
                        create_validation_set_every=0, **common)
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
