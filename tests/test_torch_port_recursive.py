"""The port's sequential recursion (``eval/recursive.py``:
``BatchSubgameSolver``, ``compute_strategy_recursive``,
``compute_strategy_recursive_to_leaf`` and its sampled and ``root_only``
forms) against the JAX package on the CPU, in float64: 1e-10 for
fictitious play, 1e-8 for CFR (its last iterates amplify rounding).  The
value function is a fixed random map ``0.5 tanh(query @ W)`` in float64
in both packages (a CFVNet computes in float32 in both, where XLA's and
torch's products round apart, and the oracle is too slow for many
cases).  Also the reference C++ fixture
``tests/golden/toleaf_oracle_1x2.json`` with the oracle net.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu import tree as jtree
from rebel_tpu.eval import recursive as jrec
from rebel_tpu.nets import value_nets as jvn
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch import tree
from rebel_tpu_torch.eval import recursive
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets import value_nets
from rebel_tpu_torch.solving import exploitability as ex
from rebel_tpu_torch.solving.params import SubgameSolvingParams

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
TOL = {True: 1e-8, False: 1e-10}  # by use_cfr


def value_fns(faces=2, seed=0):
    """The same float64 value function ``0.5 tanh(query @ W)`` in both
    packages."""
    game, jgame = LiarsDice(1, faces), JLiarsDice(1, faces)
    W = np.random.RandomState(seed).randn(game.query_size, game.num_hands)
    Wt, Wj = torch.as_tensor(W), jnp.asarray(W)
    return (game, lambda q: 0.5 * torch.tanh(q.double() @ Wt), jgame,
            lambda q: 0.5 * jnp.tanh(q.astype(jnp.float64) @ Wj))


def params_pair(use_cfr, num_iters=16, **kw):
    kw = dict(num_iters=num_iters, max_depth=2, linear_update=True,
              use_cfr=use_cfr, **kw)
    return SubgameSolvingParams(**kw), JParams(**kw)


@pytest.mark.parametrize("root", [0, 1, 5, 20])
def test_map_supertree_to_full_equals_jax(root):
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    got = recursive._map_supertree_to_full(tree.build_supertree(game, 2),
                                           tree.unroll_tree(game), root)
    want = jrec._map_supertree_to_full(jtree.build_supertree(jgame, 2),
                                       jtree.unroll_tree(jgame), root)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_batch_subgame_solver_equals_jax(use_cfr):
    """Random roots, beliefs and stop iterations (0 and the last included);
    every output of the batched solve, in chunks that do not divide the
    batch."""
    game, vf, jgame, jvf = value_fns()
    sp, jsp = params_pair(use_cfr)
    rng = np.random.RandomState(3)
    B = 7
    bids = rng.randint(-1, game.num_actions - 1, B)
    players = rng.randint(0, 2, B)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(B, 2))
    stops = np.array([0, 16, 3, 8, 15, 1, 16])  # 16 = num_iters
    got = recursive.BatchSubgameSolver(game, sp, torch.float64, vf,
                                       device="cpu").solve(
        bids, players, beliefs, stops, chunk=3)
    want = jrec.BatchSubgameSolver(jgame, jsp, jnp.float64, jvf).solve(
        bids, players, beliefs, stops)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL[use_cfr],
                                   rtol=0)


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_compute_strategy_recursive_equals_jax(use_cfr):
    game, vf, jgame, jvf = value_fns()
    sp, jsp = params_pair(use_cfr)
    got = recursive.compute_strategy_recursive(game, sp, vf, torch.float64,
                                               device="cpu")
    want = jrec.compute_strategy_recursive(jgame, jsp, jvf, jnp.float64)
    np.testing.assert_allclose(got, want, atol=TOL[use_cfr], rtol=0)


@pytest.mark.parametrize("mode", ["average", "sampled", "root_only"])
@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_to_leaf_equals_jax(mode, use_cfr):
    """The average strategy, the sampled one (stop iterations drawn from
    the same seed) and the sampled one with full-depth solves below the
    root."""
    game, vf, jgame, jvf = value_fns()
    sp, jsp = params_pair(use_cfr, num_iters=20)
    kw = {"average": {}, "sampled": dict(sample_iters_seed=7),
          "root_only": dict(sample_iters_seed=2, root_only=True)}[mode]
    got = recursive.compute_strategy_recursive_to_leaf(
        game, sp, vf, dtype=torch.float64, device="cpu", **kw)
    want = jrec.compute_strategy_recursive_to_leaf(jgame, jsp, jvf,
                                                   dtype=jnp.float64, **kw)
    np.testing.assert_allclose(got, want, atol=TOL[use_cfr], rtol=0)
    if mode != "average":
        again = recursive.compute_sampled_strategy_recursive_to_leaf(
            game, sp, vf, seed=kw["sample_iters_seed"],
            root_only=kw.get("root_only", False), dtype=torch.float64,
            device="cpu")
        np.testing.assert_array_equal(again, got)


def test_to_leaf_golden_oracle_1x2():
    """The reference C++ at 1x2, 64 iterations, depth 2, linear FP, the
    oracle net, unsampled (tools/golden/golden_recursive.cc).  Both
    packages give the same strategy and the fixture's e0/e1 to 1e-8, but
    both differ from the fixture's strategy at two infostates (node 3 and
    node 15, hand 0; ROADMAP Queue 3): the port is held to the JAX package
    there and to the fixture everywhere else."""
    fixture = json.loads((GOLDEN / "toleaf_oracle_1x2.json").read_text())
    game, jgame = LiarsDice(1, 2), JLiarsDice(1, 2)
    sp, jsp = params_pair(False, num_iters=64)
    oracle = value_nets.make_oracle_value_fn(
        game, sp.replace(max_depth=100000), torch.float64, "cpu")
    got = recursive.compute_strategy_recursive_to_leaf(
        game, sp, oracle, dtype=torch.float64, device="cpu")
    want = jrec.compute_strategy_recursive_to_leaf(
        jgame, jsp, jvn.make_oracle_value_fn(
            jgame, JParams(**{**jsp.__dict__, "max_depth": 100000}),
            jnp.float64), dtype=jnp.float64)
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)
    e0, e1 = ex.compute_exploitability2(
        ex.full_tree_context(game, torch.float64, "cpu"), got)
    assert abs(e0 - fixture["e0"]) < 1e-6 and abs(e1 - fixture["e1"]) < 1e-6
    golden = np.array(fixture["strategy"]).reshape(got.shape)
    gap = np.abs(got - golden).max(-1) > 1e-6  # [N, H]
    assert sorted(map(tuple, np.argwhere(gap))) == [(3, 0), (15, 0)]
