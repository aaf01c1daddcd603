"""The port's batch-first depth-2 solver (``solving/grid2.py``), the
``fast`` self-play engine and the ``fast`` frontier engine, on the CPU.

* ``Grid2Solver`` against the JAX package's (``jax.vmap`` over the lanes)
  step by step: CFR linear, DCFR and FP, with and without a net carried
  across by the weight converter, in f64 to 1e-10 and in f32 to 1e-5;
* against the port's batch-last solver (``grid2b``) on the same subgames;
* the cases of ``tests/test_grid2.py`` (the JAX package's own): agreement
  with the generic solver, DCFR, compact against dense queries, the fast
  engine's first step, episodes run;
* ``run_eval(engine="fast")`` against the JAX package's at a small size.

Inputs come from numpy seeds and cross as numpy arrays; the test session
enables x64 for JAX.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.eval.recursive_eval import run_eval as jrun_eval
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.nets.value_nets import zero_value_fn as jzero_value_fn
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.grid2 import Grid2Solver as JGrid2Solver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.eval.recursive_eval import run_eval
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.nets.value_nets import net_value_fn, zero_value_fn
from rebel_tpu_torch.selfplay.fast_runner import (
    FastSelfPlayEngine,
    make_engine,
)
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
    SelfPlayEngine,
)
from rebel_tpu_torch.solving.core import RootCtx, SolverContext
from rebel_tpu_torch.solving.grid2 import Grid2Solver
from rebel_tpu_torch.solving.grid2b import Grid2BatchSolver, RootCtxB
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.solving.solver import build_solver
from rebel_tpu_torch.tree import build_supertree

@pytest.fixture(autouse=True)
def one_thread():
    """Small tensor programs in a loop: one thread each, so that the test
    workers running side by side do not wait for each other's threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


STATE = ("regrets0", "sum0", "last0", "regrets1", "sum1", "last1",
         "root_values_means")
SOLVERS = {
    "cfr_linear": dict(use_cfr=True, linear_update=True),
    "cfr_dcfr": dict(use_cfr=True, dcfr=True, dcfr_alpha=1.5,
                     dcfr_beta=0.5, dcfr_gamma=2.0),
    "fp_linear": dict(use_cfr=False, linear_update=True),
    "fp_optimistic": dict(use_cfr=False, linear_update=True,
                          optimistic=True),
}
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-10),
          "f32": (torch.float32, jnp.float32, 1e-5)}


def _roots(game, rng, n):
    """``n`` subgame roots with legal actions left, and their beliefs."""
    bids = rng.randint(-1, game.num_actions - 2, size=n)
    bids[0] = -1
    players = rng.randint(0, 2, size=n)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(n, 2))
    return bids, players, beliefs


def _net(game, dtype, seed=3, n_hidden=16, n_layers=2):
    """``(jax value_fn, port value_fn)`` of one net in ``dtype``."""
    spec = CFVNetSpec(game=JLiarsDice(game.num_dice, game.num_faces),
                      n_hidden=n_hidden, n_layers=n_layers,
                      compute_dtype=DTYPES[dtype][1])
    params = spec.init_params(jax.random.PRNGKey(seed))
    net = net_from_state_dict(
        from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), params)),
        game).to(DTYPES[dtype][0])
    params = jax.tree.map(lambda x: jnp.asarray(x, DTYPES[dtype][1]), params)
    return spec.value_fn(params), net_value_fn(net)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("net", ["net", "zero"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_grid2_steps_match_jax(solver, net, dtype):
    game, jgame = LiarsDice(1, 4), JLiarsDice(1, 4)
    tdt, jdt, atol = DTYPES[dtype]
    kw = dict(num_iters=6, max_depth=2, **SOLVERS[solver])
    if net == "net":
        jvf, vf = _net(game, dtype)
    else:
        jvf, vf = jzero_value_fn(jgame), zero_value_fn(game)
    bids, players, beliefs = _roots(game, np.random.RandomState(7), 5)

    jsolver = JGrid2Solver(game=jgame, params=JParams(**kw), dtype=jdt,
                           value_fn=jvf)
    jroot = jax.vmap(lambda b, p: JRootCtx.of(jgame, b, p))(bids, players)
    jstate = jax.vmap(jsolver.init)(jroot, jnp.asarray(beliefs, jdt))
    solver = Grid2Solver(game, SubgameSolvingParams(**kw), tdt, vf,
                         device="cpu")
    root = RootCtx.of(game, torch.as_tensor(bids), torch.as_tensor(players))
    state = solver.init(root, torch.as_tensor(beliefs))
    jsteps = [jax.jit(jax.vmap(lambda s, r, t=t: jsolver.step(s, t, r)))
              for t in (0, 1)]
    with torch.no_grad():
        for it in range(kw["num_iters"]):
            jstate = jsteps[it % 2](jstate, jroot)
            state = solver.step(state, it % 2, root)
            for name in STATE:
                np.testing.assert_allclose(
                    getattr(state, name).numpy(),
                    np.asarray(getattr(jstate, name)), atol=atol, rtol=0,
                    err_msg=f"{name} after step {it}")
    for got, want in zip(solver.sampling_strategy(state, root),
                         jax.vmap(jsolver.sampling_strategy)(jstate, jroot)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_grid2_matches_grid2b(use_cfr):
    """The batch-first and the batch-last solver on the same subgames, f64:
    every state tensor after 8 steps."""
    game = LiarsDice(1, 4)
    sub = SubgameSolvingParams(num_iters=8, max_depth=2, linear_update=True,
                               use_cfr=use_cfr)
    _, vf = _net(game, "f64", seed=4)
    bids, players, beliefs = _roots(game, np.random.RandomState(8), 6)
    bids, players = torch.as_tensor(bids), torch.as_tensor(players)
    beliefs = torch.as_tensor(beliefs)
    first = Grid2Solver(game, sub, torch.float64, vf, device="cpu")
    last = Grid2BatchSolver(game, sub, torch.float64,
                            mlp=lambda x: vf(x.T).T, device="cpu")
    root, rootb = (RootCtx.of(game, bids, players),
                   RootCtxB.of(game, bids, players))
    s = first.init(root, beliefs)
    sb = last.init(rootb, beliefs.permute(1, 2, 0))
    with torch.no_grad():
        for it in range(sub.num_iters):
            s = first.step(s, it % 2, root)
            sb = last.step(sb, it % 2, rootb)
    for name in STATE:
        got, want = getattr(s, name), getattr(sb, name)
        torch.testing.assert_close(got, want.movedim(-1, 0), atol=1e-10,
                                   rtol=0, msg=name)


def _grid_to_node(game, sup, g0, g1):
    """Grid strategies ``[H, A]``, ``[A, H, A]`` on the supertree's nodes."""
    out = np.zeros((sup.num_nodes, game.num_hands, game.num_actions))
    out[0] = g0
    for a1 in range(game.num_actions):
        n1 = int(sup.child_index[0, a1])
        if n1 >= 0:
            out[n1] = g1[a1]
    return out


@pytest.mark.parametrize("net", ["zero", "mlp"])
@pytest.mark.parametrize("solver", ["cfr_linear", "fp_linear", "cfr_dcfr"])
def test_grid2_matches_generic(solver, net):
    """As tests/test_grid2.py: root values and the average and sampling
    strategies on legal entries equal the generic solver's on the depth-2
    supertree, f64, at 1e-12 (DCFR at 1x3 with the zero net, as there)."""
    game = LiarsDice(1, 3 if solver == "cfr_dcfr" else 4)
    sub = SubgameSolvingParams(
        num_iters=16 if solver == "cfr_dcfr" else 24, max_depth=2,
        **SOLVERS[solver])
    vf = zero_value_fn(game) if net == "zero" else _net(
        game, "f64", n_hidden=32)[1]
    sup = build_supertree(game, 2)
    ctx = SolverContext(game=game, tree=sup, dtype=torch.float64,
                        device="cpu")
    gen = build_solver(ctx, sub, vf)
    grid = Grid2Solver(game, sub, torch.float64, vf, device="cpu")
    rng = np.random.RandomState(11)
    for bid, player in [(-1, 0), (0, 1), (3, 0), (game.num_actions - 2, 1)]:
        beliefs = torch.as_tensor(rng.dirichlet(np.ones(game.num_hands),
                                                size=2))
        root = RootCtx.of(game, torch.tensor(bid), torch.tensor(player))
        broot = RootCtx.of(game, torch.tensor([bid]), torch.tensor([player]))
        with torch.no_grad():
            gstate = gen.multistep(gen.init(root, beliefs), root)
            fstate = grid.multistep(grid.init(broot, beliefs[None]), broot)
        torch.testing.assert_close(fstate.root_values_means[0],
                                   gstate.root_values_means, atol=1e-12,
                                   rtol=0)
        valid = ctx.action_masks(root).numpy()[:, None, :].repeat(
            game.num_hands, 1)
        for f, g in ((grid.average_strategy(fstate, broot),
                      gen.average_strategy(gstate, root)),
                     (grid.sampling_strategy(fstate, broot),
                      gen.sampling_strategy(gstate))):
            f_node = _grid_to_node(game, sup, f[0][0].numpy(),
                                   f[1][0].numpy())
            np.testing.assert_allclose(f_node[valid], g.numpy()[valid],
                                       atol=1e-12)


def test_grid2_compact_queries_match_dense():
    game = LiarsDice(1, 4)
    sub = SubgameSolvingParams(num_iters=16, max_depth=2,
                               linear_update=True, use_cfr=True)
    _, vf = _net(game, "f64", seed=1, n_hidden=24, n_layers=1)
    root = RootCtx.of(game, torch.tensor([2, -1]), torch.tensor([1, 0]))
    beliefs = torch.as_tensor(np.random.RandomState(2).dirichlet(
        np.ones(game.num_hands), size=(2, 2)))
    out = []
    for compact in (False, True):
        s = Grid2Solver(game, sub, torch.float64, vf,
                        compact_queries=compact, device="cpu")
        with torch.no_grad():
            out.append(s.multistep(s.init(root, beliefs), root))
    torch.testing.assert_close(out[1].root_values_means,
                               out[0].root_values_means, atol=1e-12, rtol=0)


def _fast_cfg(use_cfr, num_iters=12):
    return RecursiveSolvingParams(
        num_dice=1, num_faces=3,
        subgame_params=SubgameSolvingParams(
            num_iters=num_iters, max_depth=2, linear_update=True,
            use_cfr=use_cfr),
        random_action_prob=0.25, sample_leaf=True)


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_fast_engine_first_step_matches_generic(use_cfr):
    """From the same states and the same generator, the fast and the
    generic engine emit the same training examples and walk to the same
    states (f64)."""
    cfg = _fast_cfg(use_cfr)
    game = cfg.game
    net = net_from_state_dict(from_flax(jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        CFVNetSpec(game=JLiarsDice(1, 3), n_hidden=16, n_layers=1)
        .init_params(jax.random.PRNGKey(0)))), game).double()
    ep = EpisodeState.initial_batch(game, 3, "cpu", torch.float64)
    fast = make_engine(cfg, torch.float64, kind="fast")
    assert type(fast) is FastSelfPlayEngine
    got = fast.batch_step(ep, net, torch.Generator().manual_seed(5))
    want = SelfPlayEngine(cfg, torch.float64).batch_step(
        ep, net, torch.Generator().manual_seed(5))
    for x, y in zip([*got[0], *got[1]], [*want[0], *want[1]]):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=0)


def test_fast_engine_runs_episodes():
    cfg = _fast_cfg(True, num_iters=32)
    game = cfg.game
    engine = make_engine(cfg, torch.float64)  # auto at depth 2: fast
    assert type(engine) is FastSelfPlayEngine
    ep = EpisodeState.initial_batch(game, 8, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(0)
    ended_any = False
    for _ in range(10):
        ep, out = engine.batch_step(ep, zero_value_fn(game), gen)
        ended_any |= bool(out.ended.any())
        torch.testing.assert_close(ep.beliefs.sum(-1),
                                   torch.ones(8, 2, dtype=torch.float64),
                                   atol=1e-9, rtol=0)
        assert bool((ep.root_bid < game.liar_call).all())
    assert ended_any


@pytest.mark.parametrize("use_cfr", [True, False], ids=["cfr", "fp"])
def test_run_eval_fast_matches_jax(use_cfr):
    """The paper protocol's two phases at 1x3, 16 iterations, 4 repeats,
    f64, with a net: the port's fast frontier engine against the JAX
    package's, report for report, to 1e-9."""
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    kw = dict(num_iters=16, max_depth=2, linear_update=True, use_cfr=use_cfr)
    jvf, vf = _net(game, "f64", seed=6)
    common = dict(subgame_iters=16, num_repeats=4, mdp_depth=2,
                  regret_summary_report=False)
    want = jrun_eval(jgame, JParams(**kw), jvf, dtype=jnp.float64,
                     engine="fast", **common)
    got = run_eval(game, SubgameSolvingParams(**kw), vf,
                   dtype=torch.float64, engine="fast", device="cpu",
                   **common)
    assert got["net_compute_dtype"] == "float64"
    assert got["lane_block"] is None
    assert len(got["sampled_reports"]) == len(want["sampled_reports"]) == 3
    for g, w in zip(got["sampled_reports"], want["sampled_reports"]):
        for key in ("repeats", "e0", "e1", "exploitability", "ev_full"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-9, rtol=0,
                                       err_msg=key)


def test_drift_needs_the_card(tmp_path):
    """``python3 chip_studies.py drift`` measures the card and refuses
    without one."""
    import importlib.util

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_studies.py"
    spec = importlib.util.spec_from_file_location("chip_studies", path)
    studies = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(studies)
    with pytest.raises(SystemExit, match="card"):
        studies.main(["drift", "--out", str(tmp_path)])


@pytest.mark.parametrize("solver", ["fp", "cfr"])
def test_eval_sum_order_on_the_cpu(tmp_path, solver):
    """``python3 chip_studies.py eval-sum-order`` on the CPU at a small
    size: the plain version's sampled evaluation with the MLP's sums in
    f32 and exact in f64 (the 1x4f nets, 16 subgame iterations, where
    the two agree to f32 rounding), one row per solver in its json."""
    import importlib.util
    import json

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_studies.py"
    spec = importlib.util.spec_from_file_location("chip_studies", path)
    studies = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(studies)
    torch.set_num_threads(1)
    rows = studies.main(["eval-sum-order", "--out", str(tmp_path),
                         "--game", "1x4", "--solvers", solver,
                         "--repeats", "2", "--iters", "16",
                         "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["solver"] == solver
    assert 0 < rows[0]["f32_exploitability"] < 1
    assert rows[0]["relative_diff"] < 1e-4
    assert json.loads((tmp_path / "eval_sum_order.json").read_text()) == rows
