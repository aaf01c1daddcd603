"""The port's strategy statistics and net-quality diagnostics
(``eval/stats.py``) against the JAX package on the CPU: the statistics of
random full-tree strategies in float64 at 1e-10, and ``eval_net`` (the
``eval_mse/*`` training metrics) with the oracle value net at 1e-8
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.eval import stats as jstats
from rebel_tpu.nets import value_nets as jvn
from rebel_tpu.solving import exploitability as jex
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch import tree
from rebel_tpu_torch.eval import stats
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets import value_nets
from rebel_tpu_torch.solving import exploitability as ex
from rebel_tpu_torch.solving.params import SubgameSolvingParams


def random_strategy(game, seed):
    """A random full-tree strategy, normalised over each node's legal
    actions."""
    t = tree.unroll_tree(game)
    rng = np.random.RandomState(seed)
    s = rng.rand(t.num_nodes, game.num_hands, game.num_actions)
    s *= t.action_mask[:, None, :]
    s /= np.where(s.sum(-1, keepdims=True) > 0, s.sum(-1, keepdims=True), 1)
    return s


@pytest.mark.parametrize("faces", [2, 3])
def test_strategy_stats_equal_jax(faces):
    game, jgame = LiarsDice(1, faces), JLiarsDice(1, faces)
    strategy = random_strategy(game, faces)
    got = stats.compute_strategy_stats(
        ex.full_tree_context(game, torch.float64, "cpu"), strategy)
    want = jstats.compute_strategy_stats(
        jex.full_tree_context(jgame, jnp.float64), strategy)
    for f in ("reach_probabilities", "values", "node_values", "node_reach"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-10, rtol=0, err_msg=f)


@pytest.mark.parametrize("traverse_by_net", [True, False],
                         ids=["net_reach", "fp_reach"])
def test_eval_net_equals_jax(traverse_by_net):
    """Both packages' oracle answers the float32 queries with a float64
    solve; the best-response solves run 8 iterations of linear FP."""
    faces, fp_iters = 3, 8
    game, jgame = LiarsDice(1, faces), JLiarsDice(1, faces)
    kw = dict(num_iters=4, max_depth=100000, linear_update=True)
    oracle = value_nets.make_oracle_value_fn(
        game, SubgameSolvingParams(**kw), torch.float64, "cpu")
    joracle = jvn.make_oracle_value_fn(jgame, JParams(**kw), jnp.float64)
    net_s, full_s = random_strategy(game, 1), random_strategy(game, 2)
    args = dict(mdp_depth=1, fp_iters=fp_iters,
                traverse_by_net=traverse_by_net)
    got = stats.eval_net(game, net_s, full_s, value_fn=oracle,
                         dtype=torch.float64, device="cpu", **args)
    want = jstats.eval_net(jgame, net_s, full_s, value_fn=joracle,
                           dtype=jnp.float64, **args)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-8)


def test_eval_net_without_reachable_nodes_is_zero():
    game = LiarsDice(1, 2)
    s = random_strategy(game, 0)
    assert stats.eval_net(game, s, s, mdp_depth=1, fp_iters=2,
                          value_fn=value_nets.zero_value_fn(game),
                          traverse_by_net=True, min_reach=2.0,
                          device="cpu") == 0.0
