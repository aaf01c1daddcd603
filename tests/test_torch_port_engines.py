"""The port's batch-last and generic self-play engines, the engine factory
and the trainer's choice of engine, against the JAX package on the CPU.

``jax.random`` and ``torch.Generator`` give different numbers, so each
parity test computes the JAX engine's draws (stop iterations and actions)
from its keys and hands them to the port's solve and walk.  Tolerances are
those the JAX package holds its own engines to
(``tests/test_grid2_pallas.py``): values 2e-5, queries 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.selfplay.fast_runner import FastBatchedEngine as JBatched
from rebel_tpu.selfplay.fast_runner import make_engine as jmake_engine
from rebel_tpu.selfplay.fast_runner import sample_action
from rebel_tpu.selfplay.runner import EpisodeState as JEpisodeState
from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRSP
from rebel_tpu.selfplay.runner import SelfPlayEngine as JSelfPlayEngine
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.core import normalize_safe as jnormalize_safe
from rebel_tpu.solving.core import reach_eps as jreach_eps
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.selfplay import fast_runner
from rebel_tpu_torch.selfplay.fast_runner import (
    FastBatchedEngine,
    FastCudaEngine,
    FastSelfPlayEngine,
    advance,
    make_engine,
)
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
    SelfPlayEngine,
)
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig

B = 8


def _cfgs(depth, faces=3, sample_leaf=True, num_iters=6, use_cfr=True):
    sub = dict(num_iters=num_iters, max_depth=depth, linear_update=True,
               use_cfr=use_cfr)
    env = dict(num_dice=1, num_faces=faces, random_action_prob=0.25,
               sample_leaf=sample_leaf)
    return (JRSP(subgame_params=JParams(**sub), **env),
            RecursiveSolvingParams(subgame_params=SubgameSolvingParams(**sub),
                                   **env))


def _nets(jgame, game, n_layers=1, seed=0):
    spec = CFVNetSpec(game=jgame, n_hidden=16, n_layers=n_layers)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(seed)))
    return spec, params, net_from_state_dict(from_flax(params), game)


def _to_port(ep):
    return EpisodeState(
        root_bid=torch.as_tensor(np.array(ep.root_bid)).long(),
        root_player=torch.as_tensor(np.array(ep.root_player)).long(),
        beliefs=torch.as_tensor(np.array(ep.beliefs, np.float32)),
    )


def _long(x):
    return torch.as_tensor(np.array(x)).long()


def _assert_step(new, out, new_j, out_j):
    np.testing.assert_allclose(out.values.numpy(), np.asarray(out_j.values),
                               atol=2e-5)
    np.testing.assert_allclose(out.queries.numpy(),
                               np.asarray(out_j.queries), atol=1e-6)
    np.testing.assert_array_equal(out.ended.numpy(), np.asarray(out_j.ended))
    np.testing.assert_array_equal(new.root_bid.numpy(),
                                  np.asarray(new_j.root_bid))
    np.testing.assert_array_equal(new.root_player.numpy(),
                                  np.asarray(new_j.root_player))
    np.testing.assert_allclose(new.beliefs.numpy(),
                               np.asarray(new_j.beliefs), atol=2e-5)


# ------------------------------------------------- the batch-last engine
def _depth2_draws(jcfg, ep, keys, params):
    """The stop iterations and actions the JAX depth-2 engines draw from
    ``keys`` (slot 0 of the split is the solve key, slots 1-3 the walk's);
    the policies come from the fused kernel with the exact GELU, which
    agrees with the batch-last solver to 1e-5."""
    game, sub = jcfg.game, jcfg.subgame_params
    k_solve = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, sub.num_iters + 1))(
        k_solve)
    sol = Grid2PallasSolver(game=game, params=sub, lane_block=B,
                            gelu="exact", interpret=True).solve(
        ep.root_bid, ep.root_player, ep.beliefs, t, params)

    def lane(e, key, p0, p1):
        _, k_br, k_a1, k_a2 = jax.random.split(key, 4)
        root = JRootCtx.of(game, e.root_bid, e.root_player)
        br = jax.random.randint(k_br, (), 0, 2)
        actor0 = root.player
        a1 = sample_action(jcfg, k_a1, p0, root.mask, e.beliefs[actor0],
                           actor0 == br)
        actor1 = (root.player + 1) % 2
        m1 = (jnp.arange(game.num_actions) > a1) & (a1 != game.liar_call)
        a2 = sample_action(jcfg, k_a2, p1[a1], m1, e.beliefs[actor1],
                           actor1 == br)
        return a1, a2

    a1, a2 = jax.vmap(lane)(ep, keys, sol.snap0, sol.snap1)
    return t, a1, a2


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_batched_engine_matches_jax_batched_engine(use_cfr):
    jcfg, cfg = _cfgs(2, faces=3, use_cfr=use_cfr)
    _, params, net = _nets(jcfg.game, cfg.game)
    jeng = JBatched(cfg=jcfg, dtype=jnp.float32)
    eng = FastBatchedEngine(cfg=cfg)
    ep_j = JEpisodeState.initial_batch(jcfg.game, B, jnp.float32)
    for step in range(3):
        keys = jax.random.split(jax.random.PRNGKey(40 + step), B)
        new_j, out_j = jeng.batch_step(ep_j, keys, params)
        t, a1, a2 = _depth2_draws(jcfg, ep_j, keys, params)
        ep = _to_port(ep_j)
        sol = grid2p.solve_loop(cfg.game, cfg.subgame_params, ep.root_bid,
                                ep.root_player, ep.beliefs, _long(t),
                                eng._mlp(net))
        new, out = advance(cfg, ep, sol.snap0, sol.snap1, sol.rvm, _long(a1),
                           _long(a2))
        _assert_step(new, out, new_j, out_j)
        ep_j = new_j
    assert int(np.asarray(ep_j.root_bid).max()) >= 0  # left the root


def test_batched_engine_batch_step_runs_draws_solve_and_walk():
    """``batch_step`` = ``draw_stop`` -> solve -> ``draw_actions`` ->
    ``advance`` on one generator; a bf16 net runs wholly in bf16."""
    _, cfg = _cfgs(2, faces=4)
    _, _, net = _nets(_cfgs(2, faces=4)[0].game, cfg.game)
    eng = FastBatchedEngine(cfg=cfg)
    ep = EpisodeState.initial_batch(cfg.game, 6, device="cpu")
    new, out = eng.batch_step(ep, net, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    t = fast_runner.draw_stop(gen, 6, cfg.subgame_params.num_iters, "cpu")
    sol = grid2p.solve_loop(cfg.game, cfg.subgame_params, ep.root_bid,
                            ep.root_player, ep.beliefs, t, eng._mlp(net))
    a1, a2 = fast_runner.draw_actions(gen, cfg, ep, sol.snap0, sol.snap1)
    new2, out2 = advance(cfg, ep, sol.snap0, sol.snap1, sol.rvm, a1, a2)
    for x, y in zip(list(new) + list(out), list(new2) + list(out2)):
        assert torch.equal(x, y)
    half = FastBatchedEngine(cfg=cfg, net_compute_dtype=torch.bfloat16)
    _, out16 = half.batch_step(ep, net, torch.Generator().manual_seed(5))
    assert out16.values.dtype == torch.float32
    assert bool(torch.isfinite(out16.values).all())
    assert not torch.equal(out16.values, out.values)
    _, out0 = eng.batch_step(ep, None, torch.Generator().manual_seed(5))
    assert bool(torch.isfinite(out0.values).all())


# ---------------------------------------------------- the generic engine
def _generic_draws(jeng, jcfg, ep, keys, value_fn):
    """Stop iterations and walk actions ``SelfPlayEngine.step`` draws from
    ``keys`` (runner.py: ``k_solve, k_walk = split(key)``; the walk splits
    off the best-response player, then one key per step, four ways)."""
    game = jcfg.game
    sub = jcfg.subgame_params
    ctx, tree = jeng.ctx, jeng.ctx.tree
    depth = jnp.asarray(tree.depth)
    child = jnp.asarray(np.maximum(tree.child_index, 0))
    at_end = jnp.asarray(tree.is_leaf | tree.is_terminal)
    eps_reach = jreach_eps(jnp.float32)

    def lane(e, key):
        k_solve, k_walk = jax.random.split(key)
        t = jax.random.randint(k_solve, (), 0, sub.num_iters + 1)
        root = JRootCtx.of(game, e.root_bid, e.root_player)
        _, snap = jeng._solve_with_snapshot(root, e.beliefs, k_solve,
                                            value_fn)
        if not jcfg.sample_leaf:
            k_br, k_eps, k_uni, k_hand, k_act = jax.random.split(k_walk, 5)
            br = jax.random.randint(k_br, (), 0, 2)
            player = root.player
            explore = (player == br) & (
                jax.random.uniform(k_eps) < jcfg.random_action_prob)
            a_uni = jax.random.categorical(
                k_uni, jnp.where(root.mask, 0.0, -jnp.inf))
            hand = jax.random.categorical(k_hand, jnp.log(e.beliefs[player]))
            a_pol = jax.random.categorical(k_act, jnp.log(snap[0, hand, :]))
            return t, jnp.where(explore, a_uni, a_pol)[None]
        key2, k_br = jax.random.split(k_walk)
        br = jax.random.randint(k_br, (), 0, 2)
        amask = ctx.action_masks(root)

        def body(carry, k):
            node, bel, done = carry
            k_eps, k_uni, k_hand, k_act = jax.random.split(k, 4)
            player = ctx.node_player(depth[node], root)
            explore = (player == br) & (
                jax.random.uniform(k_eps) < jcfg.random_action_prob)
            a_uni = jax.random.categorical(
                k_uni, jnp.where(amask[node], 0.0, -jnp.inf))
            hand = jax.random.categorical(k_hand, jnp.log(bel[player]))
            a_pol = jax.random.categorical(
                k_act, jnp.log(snap[node, hand, :]))
            action = jnp.where(explore, a_uni, a_pol)
            row = jnormalize_safe(bel[player] * snap[node, :, action],
                                  eps_reach)
            bel = jnp.where(done, bel, bel.at[player].set(row))
            node = jnp.where(done, node, child[node, action])
            return (node, bel, done | at_end[node]), action

        _, actions = jax.lax.scan(
            body, (jnp.int32(0), e.beliefs, jnp.asarray(False)),
            jax.random.split(key2, tree.max_depth))
        return t, actions

    return jax.vmap(lane)(ep, keys)


@pytest.mark.parametrize("sample_leaf", [True, False],
                         ids=["to_leaf", "single_action"])
@pytest.mark.parametrize("depth", [1, 3])
def test_generic_engine_matches_jax_engine(depth, sample_leaf):
    jcfg, cfg = _cfgs(depth, faces=3, sample_leaf=sample_leaf, num_iters=5)
    spec, params, net = _nets(jcfg.game, cfg.game, seed=depth)
    value_fn = spec.value_fn(params)
    jeng = JSelfPlayEngine(cfg=jcfg, dtype=jnp.float32)
    eng = SelfPlayEngine(cfg=cfg)
    ep_j = JEpisodeState.initial_batch(jcfg.game, B, jnp.float32)
    left_root = False
    for step in range(4):
        keys = jax.random.split(jax.random.PRNGKey(10 * depth + step), B)
        new_j, out_j = jeng.batch_step(ep_j, keys, value_fn)
        t, actions = _generic_draws(jeng, jcfg, ep_j, keys, value_fn)
        ep = _to_port(ep_j)
        with torch.no_grad():
            state, snap = eng.solve_with_snapshot(ep, _long(t), net)
            new, out = eng.advance(ep, snap, state.root_values_means,
                                   _long(actions))
        _assert_step(new, out, new_j, out_j)
        ep_j = new_j
        left_root = left_root or int(np.asarray(ep_j.root_bid).max()) >= 0
    assert left_root


def test_generic_engine_batch_step_draws_legal_paths():
    """``batch_step`` with the port's own draws: legal states, beliefs
    that sum to one, and the same result from the same seed."""
    _, cfg = _cfgs(3, faces=3, num_iters=4)
    _, _, net = _nets(_cfgs(3)[0].game, cfg.game)
    eng = SelfPlayEngine(cfg=cfg)
    ep = EpisodeState.initial_batch(cfg.game, 16, device="cpu")
    for step in range(3):
        new, out = eng.batch_step(ep, net, torch.Generator().manual_seed(step))
        again, _ = eng.batch_step(ep, net, torch.Generator().manual_seed(step))
        assert all(torch.equal(a, b) for a, b in zip(new, again))
        assert out.queries.shape == (16, 2, cfg.game.query_size)
        assert out.values.shape == (16, 2, cfg.game.num_hands)
        assert bool((new.root_bid >= -1).all())
        assert bool((new.root_bid < cfg.game.liar_call).all())
        assert bool((new.root_bid[out.ended] == -1).all())
        torch.testing.assert_close(new.beliefs.sum(-1),
                                   torch.ones(16, 2), atol=1e-5, rtol=0)
        ep = new
    assert bool((ep.root_bid >= 0).any())


# ------------------------------------------------------ the engine factory
@pytest.mark.parametrize(
    "kind,depth,cls",
    [("auto", 2, FastSelfPlayEngine), ("auto", 3, SelfPlayEngine),
     ("generic", 2, SelfPlayEngine), ("generic", 1, SelfPlayEngine),
     ("fast", 2, FastSelfPlayEngine), ("batched", 2, FastBatchedEngine),
     ("kernel", 2, FastCudaEngine)])
def test_make_engine_kinds(kind, depth, cls):
    """As the JAX package's factory: ``auto`` is ``fast`` at depth 2."""
    _, cfg = _cfgs(depth)
    eng = make_engine(cfg, kind=kind, net_compute_dtype=torch.bfloat16)
    assert type(eng) is cls
    if cls in (FastBatchedEngine, FastCudaEngine):
        assert eng.net_compute_dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["fast", "batched", "kernel"])
def test_make_engine_refuses_other_depths_as_the_reference(kind):
    jcfg, cfg = _cfgs(3)
    jkind = "pallas" if kind == "kernel" else kind
    with pytest.raises(ValueError, match="requires max_depth == 2"):
        jmake_engine(jcfg, kind=jkind)
    with pytest.raises(ValueError, match="requires max_depth == 2"):
        make_engine(cfg, kind=kind)


def test_make_engine_unknown_kind_and_unported_fast():
    jcfg, cfg = _cfgs(2)
    with pytest.raises(ValueError, match="unknown engine kind"):
        jmake_engine(jcfg, kind="nope")
    with pytest.raises(ValueError, match="unknown engine kind"):
        make_engine(cfg, kind="nope")
    assert type(make_engine(cfg, kind="fast")) is FastSelfPlayEngine
    assert type(jmake_engine(jcfg, kind="fast")).__name__ == \
        "FastSelfPlayEngine"


def test_make_engine_passes_kernel_options():
    _, cfg = _cfgs(2)
    eng = make_engine(cfg, kind="kernel", lane_block=4, mlp_chunks=2,
                      gelu="fast", ablate="noln", interleave=2)
    assert (eng.lane_block, eng.mlp_chunks, eng.gelu, eng.ablate,
            eng.interleave) == (4, 2, "fast", "noln", 2)
    with pytest.raises(ValueError, match="options of the 'kernel' engine"):
        make_engine(cfg, kind="batched", lane_block=4)


def test_kernel_engine_passes_its_options_to_the_solve(monkeypatch):
    _, cfg = _cfgs(2, faces=4)
    _, _, net = _nets(_cfgs(2, faces=4)[0].game, cfg.game)
    seen = {}
    solve = grid2p.solve

    def spy(*a, **kw):
        seen.update(kw)
        return solve(*a, **kw)

    monkeypatch.setattr(grid2p, "solve", spy)
    eng = FastCudaEngine(cfg=cfg, lane_block=4, mlp_chunks=2, gelu="exact",
                         ablate="noln", interleave=2)
    ep = EpisodeState.initial_batch(cfg.game, 8, device="cpu")
    _, out = eng.batch_step(ep, net, torch.Generator().manual_seed(0))
    assert seen == dict(lane_block=4, mlp_chunks=2, gelu="exact",
                        ablate="noln", interleave=2)
    assert bool(torch.isfinite(out.values).all())


# ------------------------------------------------------------ the trainer
def _trainer_cfg(depth):
    _, env = _cfgs(depth, faces=3, num_iters=3)
    return TrainerConfig(env=env, n_hidden=16, n_layers=1,
                         train_epoch_size=64, train_batch_size=16,
                         replay_capacity=512, selfplay_batch=8)


def test_trainer_takes_two_steps_at_depth_3():
    trainer = Trainer(_trainer_cfg(3), device="cpu")
    assert type(trainer.engine) is SelfPlayEngine
    metrics = trainer.run(max_epochs=2)
    assert len(metrics) == 2
    assert all(np.isfinite(m["loss/train"]) for m in metrics)
    assert trainer.replay.num_add == 2 * 8 * trainer.gen_steps


@pytest.mark.parametrize(
    "kind,depth,cls",
    [(None, 2, FastCudaEngine), ("batched", 2, FastBatchedEngine),
     ("generic", 2, SelfPlayEngine), (None, 1, SelfPlayEngine)])
def test_trainer_picks_its_engine_through_the_factory(kind, depth, cls):
    """The fused solve for depth-2 subgames, the generic engine for any
    other depth; an engine from the factory replaces either."""
    cfg = _trainer_cfg(depth)
    engine = kind and make_engine(cfg.env, kind=kind)
    trainer = Trainer(cfg, device="cpu", engine=engine)
    assert type(trainer.engine) is cls
    trainer.gen_chunk()
    assert trainer.replay.num_add == 16
