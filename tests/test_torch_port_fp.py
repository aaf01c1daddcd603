"""Fictitious play in the port's depth-2 solvers against the JAX package.

Inputs come from a numpy seed and are handed to both packages as numpy
arrays.  ``step_fp``/``average_strategy`` are held to the JAX
``Grid2BatchSolver`` (f32 atol 1e-5, f64 atol 1e-10), and the FP
``solve_reference`` (the plain version of the fused CUDA kernel's FP
instantiation) to the Pallas kernel in interpret mode (atol 1e-5, the
tolerance the JAX package holds its own kernel to).

FP is discontinuous: one rounding difference in a leaf value can flip a
best response and move that iteration's weight to another action.  The
comparisons with the Pallas kernel therefore count the lanes that differ
and assert that there are none at these sizes, rather than leaving any
out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.solving.grid2b import Grid2BatchSolver as JGrid2B
from rebel_tpu.solving.grid2b import RootCtxB as JRootCtxB
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.selfplay.fast_runner import FastCudaEngine
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
)
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.grid2b import Grid2BatchSolver, RootCtxB
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig

FP_VARIANTS = {
    "plain": dict(),
    "linear": dict(linear_update=True),
    "optimistic": dict(linear_update=True, optimistic=True),
}
B = 8
BIDS = np.array([-1, 0, 2, 5, -1, 3, 6, 7], np.int32)
PLAYERS = np.array([0, 1, 0, 1, 1, 0, 1, 0], np.int32)


def _jax_net(game, use_ln=True, seed=2):
    spec = CFVNetSpec(game=JLiarsDice(game.num_dice, game.num_faces),
                      n_hidden=16, n_layers=2, use_layer_norm=use_ln)
    params = spec.init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


@pytest.mark.parametrize("variant", list(FP_VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_step_fp_matches_jax_grid2b(variant, dtype):
    """Six FP steps of the plain batch-last solver, with the net at the
    flax numerics, against the JAX grid2b: sums, last responses, running
    mean and the average strategy after every step."""
    game, jgame = LiarsDice(1, 4), JLiarsDice(1, 4)
    kw = dict(num_iters=6, max_depth=2, use_cfr=False, **FP_VARIANTS[variant])
    atol = 1e-5 if dtype == "float32" else 1e-10
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(11)
    nb = 5
    bids = np.array([-1, 0, 2, game.num_actions - 2, 4], np.int32)
    players = np.array([0, 1, 1, 0, 1], np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(2, nb)).transpose(
        0, 2, 1).astype(dtype)  # [2, H, B]
    beliefs[0, 1, 2] = 0.0  # a hand without mass: its average row stays 0
    params_j = _jax_net(game, seed=5)
    net = net_from_state_dict(from_flax(params_j), game).to(tdt)

    jsolver = JGrid2B(game=jgame, params=JParams(**kw), dtype=jnp.dtype(dtype),
                      net_params=params_j, net_compute_dtype=jnp.dtype(dtype))
    jroot = JRootCtxB.of(jgame, bids, players)
    jstate = jsolver.init(jroot, jnp.asarray(beliefs))
    solver = Grid2BatchSolver(game=game, params=SubgameSolvingParams(**kw),
                              dtype=tdt, mlp=lambda x: net(x.T).T,
                              device="cpu")
    root = RootCtxB.of(game, torch.as_tensor(bids).long(),
                       torch.as_tensor(players).long())
    state = solver.init(root, torch.as_tensor(beliefs))
    with torch.no_grad():
        for it in range(kw["num_iters"]):
            jstate = jsolver.step(jstate, it % 2, jroot)
            state = solver.step(state, it % 2, root)
            for name in ("sum0", "last0", "sum1", "last1",
                         "root_values_means"):
                got = getattr(state, name)
                assert got.dtype == tdt
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(getattr(jstate, name)),
                    atol=atol, err_msg=f"{name} after step {it}",
                )
            for got, ref, name in zip(solver.average_strategy(state, root),
                                      jsolver.average_strategy(jstate, jroot),
                                      ("avg0", "avg1")):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           atol=atol, err_msg=name)
            for got, ref in zip(solver.sampling_strategy(state, root),
                                jsolver.sampling_strategy(jstate, jroot)):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           atol=atol)


def test_step_cfr_float64_matches_jax_grid2b():
    """The CFR step in float64 (the dtype the f64 evaluation engine
    solves in) against the JAX grid2b at 1e-10."""
    game, jgame = LiarsDice(1, 3), JLiarsDice(1, 3)
    kw = dict(num_iters=5, max_depth=2, use_cfr=True, linear_update=True)
    rng = np.random.RandomState(3)
    bids = np.array([-1, 0, 2, game.num_actions - 2], np.int32)
    players = np.array([0, 1, 1, 0], np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(2, 4)).transpose(
        0, 2, 1)
    params_j = _jax_net(game, seed=5)
    net = net_from_state_dict(from_flax(params_j), game).double()
    jsolver = JGrid2B(game=jgame, params=JParams(**kw), dtype=jnp.float64,
                      net_params=params_j, net_compute_dtype=jnp.float64)
    jroot = JRootCtxB.of(jgame, bids, players)
    jstate = jsolver.init(jroot, jnp.asarray(beliefs))
    solver = Grid2BatchSolver(game=game, params=SubgameSolvingParams(**kw),
                              dtype=torch.float64, mlp=lambda x: net(x.T).T,
                              device="cpu")
    root = RootCtxB.of(game, torch.as_tensor(bids).long(),
                       torch.as_tensor(players).long())
    state = solver.init(root, torch.as_tensor(beliefs))
    with torch.no_grad():
        for it in range(kw["num_iters"]):
            jstate = jsolver.step(jstate, it % 2, jroot)
            state = solver.step(state, it % 2, root)
    for name in ("regrets0", "last0", "sum0", "regrets1", "last1", "sum1",
                 "root_values_means"):
        np.testing.assert_allclose(
            getattr(state, name).numpy(), np.asarray(getattr(jstate, name)),
            atol=1e-10, err_msg=name,
        )


def _solve_inputs(game, seed, num_iters):
    rng = np.random.RandomState(seed)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(B, 2)).astype(
        np.float32)
    t_stop = rng.randint(0, num_iters + 1, size=B).astype(np.int32)
    t_stop[:2] = (0, num_iters)  # both ends of the snapshot range
    return beliefs, t_stop


@pytest.mark.parametrize(
    "variant,net_mode",
    [("linear", "ln"), ("linear", "noln"), ("linear", "nonet"),
     ("optimistic", "ln"), ("plain", "ln"), ("optimistic", "nonet")],
)
def test_fp_solve_reference_matches_pallas_f32(variant, net_mode):
    game = LiarsDice(1, 4)
    kw = dict(num_iters=10, max_depth=2, use_cfr=False,
              **FP_VARIANTS[variant])
    beliefs, t_stop = _solve_inputs(game, 4, kw["num_iters"])
    params_j = net = None
    if net_mode != "nonet":
        params_j = _jax_net(game, use_ln=net_mode == "ln")
        net = net_from_state_dict(from_flax(params_j), game)
    ref = Grid2PallasSolver(
        game=JLiarsDice(1, 4), params=JParams(**kw), lane_block=B,
        interpret=True,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, params_j)
    out = grid2p.solve_reference(
        game, SubgameSolvingParams(**kw), torch.as_tensor(BIDS),
        torch.as_tensor(PLAYERS), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net)
    tie_lanes = np.zeros(B, bool)
    for name in ("rvm", "snap0", "snap1"):
        diff = np.abs(getattr(out, name).numpy()
                      - np.asarray(getattr(ref, name))).reshape(B, -1).max(1)
        tie_lanes |= diff > 1e-5
    # No lane is left out: a flipped best response would show here.
    assert tie_lanes.sum() == 0, f"lanes that differ: {np.nonzero(tie_lanes)}"


def test_fp_solve_reference_matches_pallas_bf16():
    game = LiarsDice(1, 4)
    kw = dict(num_iters=8, max_depth=2, use_cfr=False, linear_update=True)
    beliefs, t_stop = _solve_inputs(game, 6, kw["num_iters"])
    params_j = _jax_net(game)
    net = net_from_state_dict(from_flax(params_j), game)
    ref = Grid2PallasSolver(
        game=JLiarsDice(1, 4), params=JParams(**kw), lane_block=B,
        net_compute_dtype=jnp.bfloat16, interpret=True,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, params_j)
    out = grid2p.solve_reference(
        game, SubgameSolvingParams(**kw), torch.as_tensor(BIDS),
        torch.as_tensor(PLAYERS), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net, net_compute_dtype=torch.bfloat16)
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=2e-4, err_msg=name,
        )


def test_fp_ties_break_to_the_lowest_action():
    """Without a net every pseudo-leaf is worth exactly 0, and with
    point-mass beliefs every sum has one term, so tied values are equal
    bit for bit in both packages: the best response must then be the
    lowest tied action, as the Pallas kernel's first-occurrence scan picks
    it.  (Near-ties that differ by rounding would not do: the two
    packages sum in different orders.)"""
    game = LiarsDice(1, 4)
    kw = dict(num_iters=6, max_depth=2, use_cfr=False, linear_update=True)
    rng = np.random.RandomState(21)
    hands = rng.randint(0, game.num_hands, size=(B, 2))
    beliefs = np.eye(game.num_hands, dtype=np.float32)[hands]  # [B, 2, H]
    t_stop = np.array([0, 1, 2, 3, 4, 5, 6, 6], np.int32)
    ref = Grid2PallasSolver(
        game=JLiarsDice(1, 4), params=JParams(**kw), lane_block=B,
        interpret=True,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, None)
    out = grid2p.solve_reference(
        game, SubgameSolvingParams(**kw), torch.as_tensor(BIDS),
        torch.as_tensor(PLAYERS), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop))
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=1e-6, err_msg=name,
        )
    # Lane 6 (root bid 6) leaves a1 = 7 and then only the liar call: a
    # pure response.
    assert out.snap1[6, 7].max() == 1.0


def test_fp_solve_on_cpu_takes_plain_version_without_launching():
    game = LiarsDice(1, 4)
    sub = SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=False,
                               linear_update=True)
    beliefs, t_stop = _solve_inputs(game, 1, sub.num_iters)
    args = (game, sub, torch.as_tensor(BIDS), torch.as_tensor(PLAYERS),
            torch.as_tensor(beliefs), torch.as_tensor(t_stop), None)
    before = dict(grid2p.solve.launches_by_kernel)
    out = grid2p.solve(*args)
    ref = grid2p.solve_reference(*args)
    assert grid2p.solve.launches_by_kernel == before
    assert grid2p.kernel_name(sub) == "grid2_fp"
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # Average policies: rows sum to one over legal actions or are zero.
    sums = out.snap0.sum(-1)
    assert torch.all((sums - 1).abs().lt(1e-5) | sums.eq(0))


def test_fp_engine_and_trainer_run_on_cpu():
    """The r5_1x4fp configuration (``use_cfr=False, linear_update=True``)
    at a tiny size through the engine and one trainer epoch."""
    sub = SubgameSolvingParams(num_iters=6, max_depth=2, use_cfr=False,
                               linear_update=True)
    env = RecursiveSolvingParams(num_dice=1, num_faces=4, subgame_params=sub,
                                 random_action_prob=0.25, sample_leaf=True)
    eng = FastCudaEngine(cfg=env)
    game = env.game
    eps = EpisodeState.initial_batch(game, 16, "cpu")
    gen = torch.Generator().manual_seed(0)
    new, out = eng.batch_step(eps, None, gen)
    assert out.queries.shape == (16, 2, game.query_size)
    assert torch.isfinite(out.values).all()
    np.testing.assert_allclose(new.beliefs.sum(-1).numpy(), 1.0, atol=1e-5)
    cfg = TrainerConfig(env=env, n_hidden=16, n_layers=2, selfplay_batch=16,
                        train_epoch_size=64, train_batch_size=16,
                        replay_capacity=512, seed=0)
    metrics = Trainer(cfg, device="cpu").run(max_epochs=1)
    assert np.isfinite(metrics[0]["loss/train"])
