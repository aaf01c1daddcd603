"""The port's depth-2 self-play step against ``FastPallasEngine`` (run in
interpret mode) on the CPU, and the port's random draws in distribution.

``jax.random`` and ``torch.Generator`` give different numbers, so the
parity test computes the JAX engine's draws (stop iterations and the two
actions of each lane) from its own keys and hands them to the port's
solve and walk.  Tolerances are those the JAX package holds its own
engines to: values 2e-5, queries 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.selfplay.fast_runner import FastPallasEngine, sample_action
from rebel_tpu.selfplay.runner import EpisodeState as JEpisodeState
from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRSP
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.selfplay import fast_runner
from rebel_tpu_torch.selfplay.fast_runner import (
    FastCudaEngine,
    advance,
    draw_actions,
    draw_stop,
)
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

SUB = dict(num_iters=6, max_depth=2, linear_update=True, use_cfr=True)
B = 8


def _cfgs(faces=4, random_action_prob=0.25, sample_leaf=True):
    j = JRSP(num_dice=1, num_faces=faces, subgame_params=JParams(**SUB),
             random_action_prob=random_action_prob, sample_leaf=sample_leaf)
    p = RecursiveSolvingParams(
        num_dice=1, num_faces=faces, subgame_params=SubgameSolvingParams(**SUB),
        random_action_prob=random_action_prob, sample_leaf=sample_leaf)
    return j, p


def _jax_draws(jcfg, ep, keys, params, lane_block):
    """The stop iterations and actions ``FastPallasEngine.batch_step``
    draws from ``keys`` (fast_runner.py: the solve key is split slot 0,
    the walk uses slots 1-3)."""
    game = jcfg.game
    sub = jcfg.subgame_params
    k_solve = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, sub.num_iters + 1))(
        k_solve)
    sol = Grid2PallasSolver(game=game, params=sub, lane_block=lane_block,
                            interpret=True).solve(
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


def _to_port(ep):
    return EpisodeState(
        root_bid=torch.as_tensor(np.array(ep.root_bid)).long(),
        root_player=torch.as_tensor(np.array(ep.root_player)).long(),
        beliefs=torch.as_tensor(np.array(ep.beliefs, np.float32)),
    )


@pytest.mark.parametrize("faces,n_layers", [(3, 1), (4, 2)])
def test_engine_step_matches_pallas_engine(faces, n_layers):
    jcfg, cfg = _cfgs(faces)
    game = cfg.game
    spec = CFVNetSpec(game=jcfg.game, n_hidden=16, n_layers=n_layers)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(faces)))
    net = net_from_state_dict(from_flax(params), game)
    jeng = FastPallasEngine(cfg=jcfg, dtype=jnp.float32, lane_block=B,
                            interpret=True)
    ep_j = JEpisodeState.initial_batch(jcfg.game, B, jnp.float32)
    for step in range(3):
        keys = jax.random.split(jax.random.PRNGKey(100 * faces + step), B)
        new_j, out_j = jeng.batch_step(ep_j, keys, params)
        t, a1, a2 = _jax_draws(jcfg, ep_j, keys, params, B)
        ep = _to_port(ep_j)
        sol = grid2p.solve(game, cfg.subgame_params, ep.root_bid,
                           ep.root_player, ep.beliefs,
                           torch.as_tensor(np.array(t)), net)
        new, out = advance(cfg, ep, sol.snap0, sol.snap1, sol.rvm,
                           torch.as_tensor(np.array(a1)).long(),
                           torch.as_tensor(np.array(a2)).long())
        np.testing.assert_allclose(out.values.numpy(),
                                   np.asarray(out_j.values), atol=2e-5)
        np.testing.assert_allclose(out.queries.numpy(),
                                   np.asarray(out_j.queries), atol=1e-6)
        np.testing.assert_array_equal(out.ended.numpy(),
                                      np.asarray(out_j.ended))
        np.testing.assert_array_equal(new.root_bid.numpy(),
                                      np.asarray(new_j.root_bid))
        np.testing.assert_array_equal(new.root_player.numpy(),
                                      np.asarray(new_j.root_player))
        np.testing.assert_allclose(new.beliefs.numpy(),
                                   np.asarray(new_j.beliefs), atol=2e-5)
        ep_j = new_j
    assert int(np.asarray(ep_j.root_bid).max()) >= 0  # left the root


def test_engine_without_sample_leaf_matches_walk():
    """``sample_leaf=False``: one action per step, the turn passes."""
    _, cfg = _cfgs(random_action_prob=0.0, sample_leaf=False)
    game = cfg.game
    ep = EpisodeState.initial_batch(game, 4, device="cpu")
    p0 = torch.zeros(4, game.num_hands, game.num_actions)
    p0[..., 2] = 1.0
    p1 = torch.full((4, game.num_actions, game.num_hands, game.num_actions),
                    1.0 / game.num_actions)
    vals = torch.zeros(4, 2, game.num_hands)
    a1, a2 = draw_actions(torch.Generator().manual_seed(0), cfg, ep, p0, p1)
    assert a2 is None and torch.equal(a1, torch.full((4,), 2))
    new, out = advance(cfg, ep, p0, p1, vals, a1, a2)
    assert torch.equal(new.root_bid, a1)
    assert torch.equal(new.root_player, torch.ones(4, dtype=torch.long))
    assert not out.ended.any()


def test_engine_batch_step_composes_draws_solve_and_walk(monkeypatch):
    """``FastCudaEngine.batch_step`` = ``draw_stop`` -> solve ->
    ``draw_actions`` -> ``advance`` on one generator, with the lane block
    cut to the largest divisor of the batch (``math.gcd``)."""
    _, cfg = _cfgs()
    game = cfg.game
    net = net_from_state_dict(
        from_flax(jax.tree.map(np.asarray, CFVNetSpec(
            game=_cfgs()[0].game, n_hidden=16).init_params(
                jax.random.PRNGKey(1)))), game)
    blocks = []
    solve = grid2p.solve

    def spy(*a, lane_block, **kw):
        blocks.append(lane_block)
        return solve(*a, lane_block=lane_block, **kw)

    monkeypatch.setattr(grid2p, "solve", spy)
    eng = FastCudaEngine(cfg=cfg, lane_block=8)
    ep = EpisodeState.initial_batch(game, 12, device="cpu")
    new, out = eng.batch_step(ep, net, torch.Generator().manual_seed(3))
    assert blocks == [4]

    gen = torch.Generator().manual_seed(3)
    t = draw_stop(gen, 12, SUB["num_iters"], "cpu")
    sol = solve(game, cfg.subgame_params, ep.root_bid, ep.root_player,
                ep.beliefs, t, net)
    a1, a2 = draw_actions(gen, cfg, ep, sol.snap0, sol.snap1)
    new2, out2 = advance(cfg, ep, sol.snap0, sol.snap1, sol.rvm, a1, a2)
    for x, y in zip(list(new) + list(out), list(new2) + list(out2)):
        assert torch.equal(x, y)
    assert out.queries.shape == (12, 2, game.query_size)
    assert out.values.shape == (12, 2, game.num_hands)


def test_engine_refuses_fictitious_play():
    """Fictitious play is refused only at depths other than 2, as CFR
    is; the depth-2 engine takes both solvers."""
    sub = SubgameSolvingParams(num_iters=2, use_cfr=False, max_depth=3)
    with pytest.raises(ValueError, match="depth-2"):
        FastCudaEngine(cfg=RecursiveSolvingParams(subgame_params=sub))
    FastCudaEngine(cfg=RecursiveSolvingParams(
        subgame_params=sub.replace(max_depth=2)))


# ------------------------------------------------ (e) draws in distribution
def _chisquare(observed, expected):
    keep = expected > 0
    assert observed[~keep].sum() == 0, "a draw hit a cell of probability 0"
    return stats.chisquare(observed[keep], expected[keep]).pvalue


@pytest.mark.parametrize("explore", [0.25, 1.0])
def test_draw_actions_frequencies(explore):
    """Joint (a1, a2) frequencies against the exact mixture: the best-
    response player (a fair coin per lane) explores uniformly over legal
    actions with probability ``random_action_prob``, and otherwise a hand
    is drawn from the actor's beliefs and the action from the policy."""
    _, cfg = _cfgs(random_action_prob=explore)
    game = cfg.game
    A, H, liar = game.num_actions, game.num_hands, game.liar_call
    rng = np.random.RandomState(1)
    n = 100_000
    bid, player = 2, 1
    bel = rng.dirichlet(np.ones(H), size=2)
    mask0 = np.arange(A) > bid
    pol0 = rng.dirichlet(np.ones(A), size=H) * mask0
    pol0 /= pol0.sum(-1, keepdims=True)
    m1 = (np.arange(A)[None] > np.arange(A)[:, None]) & (
        np.arange(A)[:, None] != liar)  # [a1, a2]
    pol1 = rng.dirichlet(np.ones(A), size=(A, H)) * m1[:, None, :]
    pol1 /= np.maximum(pol1.sum(-1, keepdims=True), 1e-30)

    ep = EpisodeState(
        root_bid=torch.full((n,), bid, dtype=torch.long),
        root_player=torch.full((n,), player, dtype=torch.long),
        beliefs=torch.as_tensor(np.broadcast_to(bel, (n, 2, H)).copy(),
                                dtype=torch.float32),
    )
    p0 = torch.as_tensor(np.broadcast_to(pol0, (n, H, A)).copy(),
                         dtype=torch.float32)
    p1 = torch.as_tensor(np.broadcast_to(pol1, (n, A, H, A)).copy(),
                         dtype=torch.float32)
    a1, a2 = draw_actions(torch.Generator().manual_seed(2), cfg, ep, p0, p1)

    uni0 = mask0 / mask0.sum()
    on0 = bel[player] @ pol0  # [a1]
    uni1 = m1 / np.maximum(m1.sum(-1, keepdims=True), 1)  # [a1, a2]
    on1 = np.einsum("h,aho->ao", bel[1 - player], pol1)
    mix = lambda on, uni: (1 - explore) * on + explore * uni
    # Half the lanes explore at the root, the other half at level 1.
    joint = 0.5 * mix(on0, uni0)[:, None] * on1 + 0.5 * on0[:, None] * mix(
        on1, uni1)
    expected = np.concatenate([joint[:liar].ravel(),
                               [0.5 * mix(on0, uni0)[liar]
                                + 0.5 * on0[liar]]]) * n
    a1n, a2n = a1.numpy(), a2.numpy()
    cells = np.where(a1n == liar, liar * A, a1n * A + a2n)
    observed = np.bincount(cells, minlength=liar * A + 1)
    assert abs(expected.sum() - n) < 1e-6 * n
    assert _chisquare(observed, expected) > 1e-3


def test_draw_stop_is_uniform():
    t = draw_stop(torch.Generator().manual_seed(0), 60_000, 5, "cpu")
    observed = np.bincount(t.numpy(), minlength=6)
    assert observed.shape == (6,)
    assert _chisquare(observed, np.full(6, 10_000.0)) > 1e-3


def test_categorical_never_draws_zero_mass():
    probs = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    draws = fast_runner._categorical(torch.Generator().manual_seed(0),
                                     probs.repeat(50, 1))
    assert (draws[::2] == 1).all()
