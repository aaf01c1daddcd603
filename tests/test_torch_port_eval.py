"""The port's evaluation path against the JAX package on the CPU: the
numpy trees, the solver context, the generic CFR/FP solvers (also against
the golden fixtures of the C++ implementation), exploitability and EV,
the value-net backends, the batched sampled recursion and ``run_eval``.

Inputs come from numpy seeds and go to both packages as numpy arrays;
float64 comparisons hold 1e-10, float32 ones the tolerance of the JAX
package's own tests.  On the CPU the port's ``kernel`` engine takes the
plain version of the fused solve.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu import tree as jtree
from rebel_tpu.eval import recursive as jrec
from rebel_tpu.eval import recursive_eval as jeval
from rebel_tpu.nets import value_nets as jvn
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.solving import exploitability as jex
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.core import SolverContext as JSolverContext
from rebel_tpu.solving.params import SubgameSolvingParams as JParams
from rebel_tpu.solving.solver import build_solver as jbuild_solver

from rebel_tpu_torch import tree
from rebel_tpu_torch.eval import eval_all, recursive, recursive_eval
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets import convert, value_nets
from rebel_tpu_torch.solving import exploitability as ex
from rebel_tpu_torch.solving.core import RootCtx, SolverContext
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.solver import SubgameSolver, build_solver

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
F64 = dict(atol=1e-10, rtol=0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_net(game, seed=0, n_hidden=16, use_ln=True):
    spec = CFVNetSpec(game=JLiarsDice(game.num_dice, game.num_faces),
                      n_hidden=n_hidden, n_layers=2, use_layer_norm=use_ln)
    params = spec.init_params(jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    net = convert.net_from_state_dict(convert.from_flax(params), game)
    return spec, params, net


# ------------------------------------------------------------------ trees
TREE_FIELDS = [f.name for f in dataclasses.fields(jtree.TreeSpec)
               if f.name != "game"]


@pytest.mark.parametrize("nd,nf,root_bid,root_player,depth", [
    (1, 3, -1, 0, None), (1, 4, -1, 0, 2), (1, 4, 3, 1, 2), (1, 4, 5, 0, None),
    (2, 2, -1, 0, 3), (1, 3, 4, 1, 0),
])
def test_unroll_tree_equals_jax(nd, nf, root_bid, root_player, depth):
    a = tree.unroll_tree(LiarsDice(nd, nf), root_bid, root_player, depth)
    b = jtree.unroll_tree(JLiarsDice(nd, nf), root_bid, root_player, depth)
    for name in TREE_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(x, y, err_msg=name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, name
    assert a.level_slices == b.level_slices
    np.testing.assert_array_equal(a.terminal_ids, b.terminal_ids)
    np.testing.assert_array_equal(a.pseudo_leaf_ids, b.pseudo_leaf_ids)
    assert a.num_nodes == b.num_nodes and not a.is_supertree
    assert a.children(0) == b.children(0)
    assert a.node_player(a.num_nodes - 1) == b.node_player(b.num_nodes - 1)


@pytest.mark.parametrize("nd,nf,depth", [(1, 3, None), (1, 4, 2), (2, 2, 2)])
def test_build_supertree_equals_jax(nd, nf, depth):
    a = tree.build_supertree(LiarsDice(nd, nf), depth)
    b = jtree.build_supertree(JLiarsDice(nd, nf), depth)
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.level_slices == b.level_slices and a.is_supertree
    game = LiarsDice(nd, nf)
    for bid in (-1, 0, game.num_actions - 2):
        np.testing.assert_array_equal(
            tree.root_action_mask(game, bid),
            jtree.root_action_mask(JLiarsDice(nd, nf), bid))
    bids = np.array([-1, 2, 0])
    np.testing.assert_array_equal(
        tree.root_action_mask(game, bids),
        np.stack([tree.root_action_mask(game, int(b)) for b in bids]))


# -------------------------------------------------------- solver context
def _contexts(kind, seed=0):
    """A (port, JAX) context pair with roots, a random legal strategy,
    beliefs and a small net, all float64."""
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    if kind == "full":
        t, jt = tree.unroll_tree(game), jtree.unroll_tree(jgame)
        root = RootCtx.concrete(t, "cpu")
        jroot = JRootCtx.concrete(jt)
    else:  # a depth-2 supertree restricted to a concrete root
        t, jt = tree.build_supertree(game, 2), jtree.build_supertree(jgame, 2)
        bid, player = (-1, 0) if kind == "super_initial" else (2, 1)
        root = RootCtx.of(game, torch.tensor(bid), torch.tensor(player))
        jroot = JRootCtx.of(jgame, bid, player)
    ctx = SolverContext(game=game, tree=t, dtype=torch.float64, device="cpu")
    jctx = JSolverContext(game=jgame, tree=jt, dtype=jnp.float64)
    rng = np.random.RandomState(seed)
    amask = _np(ctx.action_masks(root))
    strat = rng.rand(t.num_nodes, game.num_hands, game.num_actions)
    strat = np.where(amask[:, None, :], strat, 0.0)
    strat = strat / np.maximum(strat.sum(-1, keepdims=True), 1e-300)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=2)
    spec, params, net = _jax_net(game, seed=3)
    return ctx, jctx, root, jroot, strat, beliefs, (spec, params, net)


@pytest.mark.parametrize("kind", ["full", "super_initial", "super_mid"])
def test_solver_context_matches_jax(kind):
    ctx, jctx, root, jroot, strat, beliefs, (spec, params, net) = \
        _contexts(kind)
    ts, tb = torch.as_tensor(strat), torch.as_tensor(beliefs)
    np.testing.assert_array_equal(_np(ctx.node_valid(root)),
                                  np.asarray(jctx.node_valid(jroot)))
    amask, jamask = ctx.action_masks(root), jctx.action_masks(jroot)
    np.testing.assert_array_equal(_np(amask), np.asarray(jamask))
    np.testing.assert_allclose(_np(ctx.uniform_strategy(amask)),
                               np.asarray(jctx.uniform_strategy(jamask)),
                               **F64)
    r, jr = [], []
    for p in (0, 1):
        r.append(ctx.compute_reaches(ts, tb[p], p, root))
        jr.append(jctx.compute_reaches(jnp.asarray(strat),
                                       jnp.asarray(beliefs[p]), p, jroot))
        np.testing.assert_allclose(_np(r[p]), np.asarray(jr[p]), **F64)
    vf = value_nets.net_value_fn(net.double())
    jvf = None
    if ctx.tree.pseudo_leaf_ids.size:
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        jvf = spec.value_fn(p64)
    for trav in (0, 1):
        np.testing.assert_allclose(
            _np(ctx.terminal_values(r[1 - trav], trav, root)),
            np.asarray(jctx.terminal_values(jr[1 - trav], trav, jroot)),
            **F64)
        if jvf is not None:
            np.testing.assert_allclose(
                _np(ctx.leaf_queries(r[0], r[1], trav, root)),
                np.asarray(jctx.leaf_queries(jr[0], jr[1], trav, jroot)),
                **F64)
        leaf = ctx.all_leaf_values(r[0], r[1], trav, root, vf)
        jleaf = jctx.all_leaf_values(jr[0], jr[1], trav, jroot, jvf)
        np.testing.assert_allclose(_np(leaf), np.asarray(jleaf), atol=1e-9)
        jleaf_t = torch.as_tensor(np.asarray(jleaf))
        v, q = ctx.backup_expected(jleaf_t, ts, trav, root, amask, True)
        jv, jq = jctx.backup_expected(jleaf, jnp.asarray(strat), trav, jroot,
                                      jamask, with_regrets=True)
        np.testing.assert_allclose(_np(v), np.asarray(jv), **F64)
        np.testing.assert_allclose(_np(q), np.asarray(jq), **F64)
        v, br = ctx.backup_best_response(jleaf_t, trav, root, amask)
        jv, jbr = jctx.backup_best_response(jleaf, trav, jroot, jamask)
        # -inf marks nodes the root masks out, in both packages.
        np.testing.assert_allclose(_np(v), np.asarray(jv), **F64)
        np.testing.assert_array_equal(_np(br), np.asarray(jbr))
    np.testing.assert_allclose(
        _np(ctx.root_query(tb, 1, root)),
        np.asarray(jctx.root_query(jnp.asarray(beliefs), 1, jroot)), **F64)


def test_solver_context_batch_dims_equal_a_loop():
    """Leading batch dimensions (roots, beliefs and strategies of many
    subgames at once) give what one call per subgame gives."""
    game = LiarsDice(1, 3)
    t = tree.build_supertree(game, 2)
    ctx = SolverContext(game=game, tree=t, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(5)
    bids = torch.tensor([-1, 0, 3, 5])
    players = torch.tensor([0, 1, 1, 0])
    root = RootCtx.of(game, bids, players)
    amask = ctx.action_masks(root)  # [4, N, A]
    strat = torch.as_tensor(rng.rand(4, t.num_nodes, game.num_hands,
                                     game.num_actions))
    strat = torch.where(amask[:, :, None, :], strat, 0.0)
    beliefs = torch.as_tensor(rng.dirichlet(np.ones(game.num_hands),
                                            size=(4, 2)))
    vf = value_nets.zero_value_fn(game)
    r0 = ctx.compute_reaches(strat, beliefs[:, 0], 0, root)
    r1 = ctx.compute_reaches(strat, beliefs[:, 1], 1, root)
    leaf = ctx.all_leaf_values(r0, r1, 1, root, vf)
    v, q = ctx.backup_expected(leaf, strat, 1, root, amask, True)
    vb, br = ctx.backup_best_response(leaf, 1, root, amask)
    for i in range(4):
        one = RootCtx.of(game, bids[i], players[i])
        am = ctx.action_masks(one)
        assert torch.equal(am, amask[i])
        a0 = ctx.compute_reaches(strat[i], beliefs[i, 0], 0, one)
        a1 = ctx.compute_reaches(strat[i], beliefs[i, 1], 1, one)
        assert torch.equal(a0, r0[i]) and torch.equal(a1, r1[i])
        lf = ctx.all_leaf_values(a0, a1, 1, one, vf)
        torch.testing.assert_close(lf, leaf[i], atol=1e-14, rtol=0)
        v1, q1 = ctx.backup_expected(lf, strat[i], 1, one, am, True)
        torch.testing.assert_close(v1, v[i], atol=1e-14, rtol=0)
        torch.testing.assert_close(q1, q[i], atol=1e-14, rtol=0)
        v2, b2 = ctx.backup_best_response(lf, 1, one, am)
        torch.testing.assert_close(v2, vb[i], atol=1e-14, rtol=0)
        assert torch.equal(b2, br[i])


# ---------------------------------------------------------- exploitability
def test_exploitability_and_ev_match_jax():
    ctx, jctx, _, _, strat, _, _ = _contexts("full", seed=1)
    _, _, _, _, strat2, _, _ = _contexts("full", seed=2)
    assert ex.full_tree_context(ctx.game, torch.float64, "cpu").N == ctx.N
    np.testing.assert_allclose(
        _np(ex.uniform_beliefs(ctx.game, torch.float64, "cpu")),
        np.asarray(jex.uniform_beliefs(jctx.game)), **F64)
    np.testing.assert_allclose(ex.compute_exploitability2(ctx, strat),
                               jex.compute_exploitability2(jctx, strat),
                               **F64)
    np.testing.assert_allclose(ex.compute_exploitability(ctx, strat2),
                               jex.compute_exploitability(jctx, strat2),
                               **F64)
    np.testing.assert_allclose(ex.compute_ev2(ctx, strat, strat2),
                               jex.compute_ev2(jctx, strat, strat2), **F64)
    np.testing.assert_allclose(
        _np(ex.compute_ev(ctx, strat2, strat)),
        np.asarray(jex.compute_ev(jctx, strat2, strat)), **F64)


def test_immediate_regrets_match_jax():
    ctx, jctx, _, _, strat, _, _ = _contexts("full", seed=1)
    stack = np.stack([_contexts("full", seed=s)[4] for s in (1, 2, 3)])
    ref = np.asarray(jex.compute_immediate_regrets(jctx, stack))
    np.testing.assert_allclose(
        _np(ex.compute_immediate_regrets(ctx, stack, block=2)), ref, **F64)
    blocks = [stack[:1].reshape(1, -1), stack[1:].reshape(2, -1)]
    np.testing.assert_allclose(
        _np(ex.immediate_regret_summary(ctx, blocks)), ref, **F64)
    assert ex.immediate_regret_summary(ctx, []) is None


# --------------------------------------------------------- generic solvers
SOLVER_CASES = {
    "cfr_linear": dict(use_cfr=True, linear_update=True),
    "cfr_dcfr": dict(use_cfr=True, dcfr=True, dcfr_alpha=1.5, dcfr_beta=0.5,
                     dcfr_gamma=2.0),
    "fp_linear": dict(use_cfr=False, linear_update=True),
    "fp_optimistic": dict(use_cfr=False, linear_update=True,
                          optimistic=True),
    "fp_plain": dict(use_cfr=False),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
@pytest.mark.parametrize("kind", ["full", "super_mid"])
def test_generic_solver_matches_jax(case, kind):
    ctx, jctx, root, jroot, _, beliefs, (spec, params, net) = _contexts(kind)
    kw = dict(num_iters=6, max_depth=10**6 if kind == "full" else 2,
              **SOLVER_CASES[case])
    vf = jvf = None
    if kind != "full":
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        vf, jvf = value_nets.net_value_fn(net.double()), spec.value_fn(p64)
    solver = build_solver(ctx, SubgameSolvingParams(**kw), vf)
    jsolver = jbuild_solver(jctx, JParams(**kw), jvf)
    state = solver.init(root, torch.as_tensor(beliefs))
    jstate = jsolver.init(jroot, jnp.asarray(beliefs))
    jstep = jax.jit(jsolver.step)
    for it in range(kw["num_iters"]):
        state = solver.step(state, it % 2, root)
        jstate = jstep(jstate, it % 2, jroot)
    for name in ("sum_strategies", "last_strategies", "root_values_means"):
        np.testing.assert_allclose(_np(getattr(state, name)),
                                   np.asarray(getattr(jstate, name)),
                                   atol=1e-9, err_msg=name)
    np.testing.assert_allclose(
        _np(solver.average_strategy(state, root)),
        np.asarray(jsolver.average_strategy(jstate, jroot)), atol=1e-9)
    np.testing.assert_allclose(
        _np(solver.sampling_strategy(state)),
        np.asarray(jsolver.sampling_strategy(jstate)), atol=1e-9)


GOLDEN_CASES = [
    # (fixture, use_cfr, linear, strategy_atol, values_atol), as in
    # tests/test_golden_parity.py.
    ("fp_linear_1x4.json", False, True, 1e-14, 1e-14),
    ("fp_plain_1x3.json", False, False, 1e-14, 1e-14),
    ("fp_optimistic_1x4.json", False, True, 1e-14, 1e-14),
    ("cfr_linear_1x4.json", True, True, 1e-4, 1e-6),
]


@pytest.mark.parametrize("fixture,use_cfr,linear,s_atol,v_atol",
                         GOLDEN_CASES)
def test_generic_solver_matches_golden(fixture, use_cfr, linear, s_atol,
                                       v_atol):
    g = json.loads((GOLDEN / fixture).read_text())
    nd, nf = g["game"]
    game = LiarsDice(nd, nf)
    t = tree.unroll_tree(game)
    assert t.num_nodes == g["num_nodes"]
    ctx = SolverContext(game=game, tree=t, dtype=torch.float64, device="cpu",
                        terminal_f32_parity=True)
    params = SubgameSolvingParams(
        num_iters=g["num_iters"], max_depth=10**6, use_cfr=use_cfr,
        linear_update=linear, optimistic=bool(g.get("optimistic", 0)))
    sub = SubgameSolver(ctx, params, RootCtx.concrete(t, "cpu"),
                        ex.uniform_beliefs(game, torch.float64, "cpu"))
    collect = use_cfr and "immediate_regrets" in g
    iterates, expl = [], []
    for it in range(g["num_iters"]):
        sub.step(it % 2)
        if collect and it % 2 == 0:
            iterates.append(_np(sub.get_sampling_strategy()))
        if ((it + 1) & it) == 0:
            expl.append(ex.compute_exploitability(ctx, sub.get_strategy()))
    np.testing.assert_allclose(np.array(expl), np.array(g["exploitability"]),
                               atol=2e-6, rtol=1e-5)
    for p in (0, 1):
        np.testing.assert_allclose(_np(sub.get_hand_values(p)),
                                   np.array(g[f"root_values_p{p}"]),
                                   atol=v_atol)
    if collect:
        regs = _np(ex.compute_immediate_regrets(ctx, np.stack(iterates)))
        ref = np.array(g["immediate_regrets"]).reshape(-1, game.num_hands)
        np.testing.assert_allclose(regs, ref, atol=1e-6)
        assert regs.min() >= 0.0
    ref_avg = np.array(g["avg_strategy"]).reshape(-1, game.num_hands,
                                                  game.num_actions)
    np.testing.assert_allclose(_np(sub.get_strategy()), ref_avg, atol=s_atol)
    assert sub.tree is t
    assert torch.equal(sub.get_belief_propagation_strategy(),
                       sub.get_sampling_strategy())


# ------------------------------------------------------------- value nets
def test_value_net_backends_match_jax():
    game, jgame = LiarsDice(1, 2), JLiarsDice(1, 2)
    rng = np.random.RandomState(4)
    A, H = game.num_actions, game.num_hands
    n = 5
    bids = np.array([-1, 0, 1, 2, 3])
    q = np.zeros((n, game.query_size))
    q[:, 0] = [0, 1, 0, 1, 0]
    q[:, 1] = [0, 0, 1, 1, 1]
    q[np.arange(n)[bids >= 0], 2 + bids[bids >= 0]] = 1.0
    q[:, 2 + A:] = rng.dirichlet(np.ones(H), size=(n, 2)).reshape(n, -1)
    z = value_nets.zero_value_fn(game)(torch.as_tensor(q))
    np.testing.assert_array_equal(
        _np(z), np.asarray(jvn.zero_value_fn(jgame)(jnp.asarray(q))))
    assert value_nets.zero_value_fn(game).__wrapped_kind__ == "zero"
    dec = value_nets.decode_query_arrays(game, torch.as_tensor(q))
    for i in range(n):
        ref = jvn.decode_query_arrays(jgame, jnp.asarray(q[i]))
        for got, want in zip(dec, ref):
            np.testing.assert_allclose(_np(got[i]), np.asarray(want))
    for kw in (dict(use_cfr=True, linear_update=True),
               dict(use_cfr=False, linear_update=True)):
        kw = dict(num_iters=12, max_depth=10**6, **kw)
        oracle = value_nets.make_oracle_value_fn(
            game, SubgameSolvingParams(**kw), torch.float64, "cpu")
        joracle = jvn.make_oracle_value_fn(jgame, JParams(**kw), jnp.float64)
        np.testing.assert_allclose(_np(oracle(torch.as_tensor(q))),
                                   np.asarray(joracle(jnp.asarray(q))),
                                   atol=1e-9)


@pytest.mark.parametrize("ckpt", ["r4_1x4cfr/ckpt/epoch990.params",
                                  "r5_1x4fp/ckpt/epoch800.params"])
def test_params_loader_matches_flax_apply(ckpt):
    """The repo's trained 1x4f nets, read without JAX, give the flax
    module's values."""
    path = REPO / "results" / "liars_sp" / ckpt
    game = LiarsDice(1, 4)
    net = convert.load_params_net(path, game, "cpu")
    assert (net.n_hidden, net.n_layers, net.use_layer_norm) == (256, 2, True)
    from rebel_tpu.training.trainer import load_params

    spec = CFVNetSpec(game=JLiarsDice(1, 4))
    x = np.random.RandomState(0).rand(7, game.query_size).astype(np.float32)
    ref = spec.value_fn(load_params(path))(jnp.asarray(x))
    vf, net2 = recursive_eval._load_net(str(path), game, "cpu")
    np.testing.assert_allclose(_np(vf(torch.as_tensor(x))), np.asarray(ref),
                               atol=2e-5)
    assert isinstance(net2, type(net))


def test_load_net_routes_net2_state_dicts(tmp_path):
    """A ``Net2`` state dict written by ``torch.save`` is no plain pickle
    of the flax layout: ``_load_net`` hands it to ``load_net2``."""
    game = LiarsDice(1, 3)
    _, _, net = _jax_net(game, seed=4)
    path = tmp_path / "net.pt"
    convert.save_net2(net, path)
    vf, loaded = recursive_eval._load_net(str(path), game, "cpu")
    x = torch.rand(3, game.query_size)
    with torch.no_grad():
        assert torch.equal(vf(x), net(x))
    assert loaded.n_hidden == net.n_hidden


def test_params_loader_refuses_other_pickles(tmp_path):
    import pickle

    path = tmp_path / "not_flax.params"
    path.write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(ValueError, match="flax"):
        convert.load_flax_params(path)


# ------------------------------------------------------ sampled recursion
def test_stop_weights_and_dtype_provenance():
    np.testing.assert_array_equal(recursive.stop_iteration_weights(9),
                                  jrec.stop_iteration_weights(9))
    r = recursive.resolved_net_compute_dtype
    assert r("plain", torch.float64) == "float64"
    assert r("plain", torch.float32, torch.bfloat16) == "float32"
    assert r("kernel", torch.float32) == "bfloat16"
    assert r("kernel", torch.float32, torch.float32) == "float32"


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
@pytest.mark.parametrize("engine", ["plain", "kernel"])
def test_sampled_strategies_match_jax(engine, use_cfr):
    """Same seeds, same stop draws: strategies lane for lane at 2e-5 in
    float32 (for FP: but for rare tie rows, which are counted).  ``plain`` is held to the JAX grid engine, ``kernel`` (on the
    CPU the plain version of the fused solve, float32 MLP) to the Pallas
    kernel in interpret mode."""
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    kw = dict(num_iters=6, max_depth=2, linear_update=True, use_cfr=use_cfr)
    spec, params, net = _jax_net(game, seed=0)
    jvf = spec.value_fn(params)
    seeds = [0, 1, 2]
    if engine == "plain":
        ref = jrec.compute_sampled_strategies_to_leaf_batch(
            jgame, JParams(**kw), jvf, seeds, dtype=jnp.float32)
        fsolver = None
    else:
        ref = jrec.compute_sampled_strategies_to_leaf_batch(
            jgame, JParams(**kw), jvf, seeds, dtype=jnp.float32,
            fsolver=jrec.Grid2FrontierSolver(
                jgame, JParams(**kw), jnp.float32, jvf, engine="pallas",
                net_params=params, lane_block=8, interpret=True))
        fsolver = recursive.Grid2FrontierSolver(
            game, SubgameSolvingParams(**kw), torch.float32, None,
            engine="kernel", net=net, lane_block=8,
            net_compute_dtype=torch.float32, device="cpu")
    out = recursive.compute_sampled_strategies_to_leaf_batch(
        game, SubgameSolvingParams(**kw), value_nets.net_value_fn(net),
        seeds, dtype=torch.float32, fsolver=fsolver, device="cpu")
    assert out.dtype == np.float32 and out.shape == ref.shape
    nonterm = ~tree.unroll_tree(game).is_terminal
    diff = np.abs(out[:, nonterm] - ref[:, nonterm]).max(-1)  # [R, n, H]
    if use_cfr:
        assert diff.max() <= 2e-5
        return
    # FP is discontinuous: with the uniform beliefs at the root, symmetric
    # actions tie exactly, and the two packages' roundings break a tie
    # differently (a policy row then differs by the weight of one best
    # response).  Such rows are counted and must be rare; all others hold
    # the tolerance.
    tie_rows = diff > 2e-5
    assert tie_rows.mean() <= 0.01, f"{tie_rows.sum()} of {tie_rows.size}"


def test_frontier_solver_pads_chunks_and_refuses_misuse():
    game = LiarsDice(1, 3)
    sub = SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=True,
                               linear_update=True)
    _, _, net = _jax_net(game, seed=1)
    rng = np.random.RandomState(0)
    B = 11  # not a multiple of the lane block, and more than one chunk
    bids = rng.randint(-1, game.num_actions - 1, B)
    players = rng.randint(0, 2, B)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(B, 2)).astype(
        np.float32)
    stops = rng.randint(0, 5, B)
    kw = dict(engine="kernel", net=net, net_compute_dtype=torch.float32,
              device="cpu")
    a0, a1 = recursive.Grid2FrontierSolver(
        game, sub, torch.float32, None, chunk=8, lane_block=4, **kw
    ).solve(bids, players, beliefs, stops)
    b0, b1 = recursive.Grid2FrontierSolver(
        game, sub, torch.float32, None, chunk=1024, lane_block=1, **kw
    ).solve(bids, players, beliefs, stops)
    assert a0.shape == (B, game.num_hands, game.num_actions)
    np.testing.assert_allclose(a0, b0, atol=1e-6)
    np.testing.assert_allclose(a1, b1, atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        recursive.Grid2FrontierSolver(game, sub, torch.float64, None,
                                      engine="kernel")
    with pytest.raises(ValueError, match="zero-net"):
        recursive.Grid2FrontierSolver(
            game, sub, torch.float32, value_nets.net_value_fn(net),
            engine="kernel")
    recursive.Grid2FrontierSolver(  # an explicit zero-net run is allowed
        game, sub, torch.float32, value_nets.zero_value_fn(game),
        engine="kernel")
    with pytest.raises(ValueError, match="engine"):
        recursive.Grid2FrontierSolver(game, sub, engine="pallas")
    with pytest.raises(ValueError, match="depth-2"):
        recursive.Grid2FrontierSolver(game, sub.replace(max_depth=3))


# ---------------------------------------------------------------- run_eval
@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_run_eval_matches_jax_f64(use_cfr, tmp_path):
    """End to end at a tiny size in float64: the full-tree exploitability,
    its trajectory, the immediate regrets and every power-of-two report
    equal the JAX package's to 1e-5."""
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    kw = dict(num_iters=8, max_depth=2, linear_update=True, use_cfr=use_cfr)
    spec, params, net = _jax_net(game, seed=2)
    ref = jeval.run_eval(jgame, JParams(**kw), spec.value_fn(params),
                         subgame_iters=8, num_repeats=3, dtype=jnp.float64)
    partial = tmp_path / "eval.partial"
    out = recursive_eval.run_eval(
        game, SubgameSolvingParams(**kw), value_nets.net_value_fn(net),
        subgame_iters=8, num_repeats=3, dtype=torch.float64,
        partial_path=partial, net_name="tiny", device="cpu")
    assert out["exploitability"].keys() == ref["exploitability"].keys()
    for k, v in ref["exploitability"].items():
        assert abs(out["exploitability"][k] - v) < 1e-5, k
    for k, v in ref["ev"].items():
        assert abs(out["ev"][k] - v) < 1e-5, k
    assert len(out["full_trajectory"]) == len(ref["full_trajectory"])
    for a, b in zip(out["full_trajectory"], ref["full_trajectory"]):
        assert a["iter"] == b["iter"] and abs(a["sum"] - b["sum"]) < 1e-9
    assert [r["repeats"] for r in out["sampled_reports"]] == [1, 2, 3]
    for a, b in zip(out["sampled_reports"], ref["sampled_reports"]):
        for key in ("e0", "e1", "exploitability", "ev_full"):
            assert abs(a[key] - b[key]) < 1e-5, (key, a, b)
    if use_cfr:
        for key in ("max", "mean"):
            assert abs(out["immediate_regrets"][key]
                       - ref["immediate_regrets"][key]) < 1e-9
    else:
        assert out["immediate_regrets"] is None
    assert out["net_compute_dtype"] == "float64"
    snap = json.loads(partial.read_text())
    assert snap["net"] == "tiny" and snap["engine"] == "plain"
    assert len(snap["sampled_reports"]) == 3


def test_run_eval_resume_equals_uninterrupted(tmp_path):
    game = LiarsDice(1, 2)
    params = SubgameSolvingParams(num_iters=4, max_depth=2,
                                  linear_update=True, use_cfr=True)
    vf = value_nets.zero_value_fn(game)
    kw = dict(subgame_iters=4, dtype=torch.float32, device="cpu",
              engine="kernel", net_name="zero", max_chunk=2,
              regret_summary_report=False)
    whole = recursive_eval.run_eval(game, params, vf, num_repeats=6, **kw)
    part = tmp_path / "p.partial"
    # A run of 6 repeats that dies after its first chunks: emulate it by
    # a 6-repeat accumulator cut at 4 repeats.
    ctx = ex.full_tree_context(game, torch.float32, "cpu")
    full, _, _ = recursive_eval.full_solve(game, params, torch.float32,
                                           device="cpu")
    sig = "1x2-cfr-4-6-net=zero-engine=kernel-bfloat16"
    recursive_eval.sampled_eval(
        game, params, vf, 4, full, dtype=torch.float32, max_chunk=2,
        acc_path=str(part) + ".acc.npz", acc_sig=sig, engine="kernel",
        device="cpu")
    resumed = recursive_eval.run_eval(game, params, vf, num_repeats=6,
                                      partial_path=part, resume=True, **kw)
    assert [r["repeats"] for r in resumed["sampled_reports"]] == [1, 2, 4, 6]
    assert resumed["exploitability"] == whole["exploitability"]
    assert resumed["ev"] == whole["ev"]
    # Another net's accumulator is refused and moved aside.
    other = recursive_eval.run_eval(
        game, params, vf, num_repeats=6, partial_path=part, resume=True,
        **{**kw, "net_name": "other"})
    assert other["exploitability"] == whole["exploitability"]
    assert (tmp_path / "p.partial.acc.npz.stale").exists()
    del ctx


def test_sampled_eval_refuses_other_depths():
    game = LiarsDice(1, 2)
    params = SubgameSolvingParams(num_iters=2, max_depth=3, use_cfr=True)
    with pytest.raises(NotImplementedError, match="depth-2"):
        recursive_eval.sampled_eval(game, params,
                                    value_nets.zero_value_fn(game), 1, None,
                                    mdp_depth=3, device="cpu")
    with pytest.raises(ValueError, match="value net"):
        recursive_eval.run_eval(game, params.replace(max_depth=2), None,
                                subgame_iters=2, num_repeats=1,
                                dtype=torch.float32, device="cpu")


def test_acting_player_reach_matches_jax():
    ctx, jctx, _, _, strat, _, _ = _contexts("full", seed=6)
    ref = jeval.acting_player_reach(jctx, strat)
    np.testing.assert_allclose(recursive_eval.acting_player_reach(ctx, strat),
                               ref, **F64)
    both = recursive_eval.acting_player_reach_batch(ctx,
                                                    np.stack([strat, strat]))
    np.testing.assert_allclose(both[1], ref, **F64)


def test_eval_all_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = eval_all.main([
        "--games", "1x2", "--solvers", "cfr", "fp", "--net", "zero",
        "--subgame-iters", "4", "--num-repeats", "2", "--device", "cpu",
        "--out", str(out)])
    assert [r["solver"] for r in rows] == ["cfr", "fp"]
    assert json.loads(out.read_text())[0]["engine"] == "kernel"
    assert rows[0]["net_compute_dtype"] == "bfloat16"
    assert all(np.isfinite(r["rebel"]) for r in rows)
    assert not list(tmp_path.glob("*.partial*"))
    assert "XXX" in capsys.readouterr().out
    rows = eval_all.main([
        "--games", "1x2", "--solvers", "fp", "--net", "oracle", "--f64",
        "--subgame-iters", "4", "--num-repeats", "1", "--device", "cpu",
        "--out", str(out)])
    assert rows[0]["engine"] == "plain"
    assert rows[0]["net_compute_dtype"] == "float64"
    with pytest.raises(SystemExit):
        eval_all.main(["--engine", "kernel", "--f64", "--device", "cpu"])
    with pytest.raises(SystemExit):
        eval_all.main(["--net", "oracle", "--device", "cpu"])
    with pytest.raises(SystemExit, match="CUDA"):
        eval_all.main(["--games", "1x2"])
