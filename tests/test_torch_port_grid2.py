"""The port's depth-2 solvers against the JAX package on the CPU.

``solve_reference`` (the plain version of the fused CUDA kernel) must
match ``Grid2PallasSolver`` run in interpret mode at atol 1e-5 in f32 —
the tolerance the JAX package holds its own kernel to against grid2b
(tests/test_grid2_pallas.py).  Inputs come from a numpy seed and are
handed to both packages as numpy arrays; the JAX side is cast to f32
explicitly because the test session enables x64.
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
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.grid2b import Grid2BatchSolver, RootCtxB
from rebel_tpu_torch.solving.params import SubgameSolvingParams

B = 8
BIDS = np.array([-1, 0, 2, 5, -1, 3, 6, 7], np.int32)
PLAYERS = np.array([0, 1, 0, 1, 1, 0, 1, 0], np.int32)


def _inputs(game, seed, num_iters):
    rng = np.random.RandomState(seed)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(B, 2)).astype(
        np.float32
    )
    t_stop = rng.randint(0, num_iters + 1, size=B).astype(np.int32)
    t_stop[:2] = (0, num_iters)  # both ends of the snapshot range
    return beliefs, t_stop


def _jax_net(game, use_ln, seed=2):
    spec = CFVNetSpec(game=JLiarsDice(game.num_dice, game.num_faces),
                      n_hidden=16, n_layers=2, use_layer_norm=use_ln)
    params = spec.init_params(jax.random.PRNGKey(seed))
    return spec, jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _port(game, sub, beliefs, t_stop, net, dtype=torch.float32):
    return grid2p.solve_reference(
        game, sub, torch.as_tensor(BIDS), torch.as_tensor(PLAYERS),
        torch.as_tensor(beliefs), torch.as_tensor(t_stop), net,
        net_compute_dtype=dtype,
    )


VARIANTS = {
    "linear": dict(linear_update=True),
    "dcfr": dict(dcfr=True, dcfr_alpha=1.5, dcfr_beta=0.5, dcfr_gamma=2.0),
    "dcfr_clamped": dict(dcfr=True, dcfr_alpha=5.0, dcfr_beta=-5.0,
                         dcfr_gamma=1.0),
    "plain": dict(),
}


@pytest.mark.parametrize(
    "variant,net_mode",
    [("linear", "ln"), ("linear", "noln"), ("linear", "nonet"),
     ("dcfr", "ln"), ("dcfr_clamped", "ln"), ("plain", "ln")],
)
def test_solve_reference_matches_pallas_f32(variant, net_mode):
    game = LiarsDice(1, 4)
    kw = dict(num_iters=10, max_depth=2, use_cfr=True, **VARIANTS[variant])
    beliefs, t_stop = _inputs(game, 4, kw["num_iters"])
    params_j = None
    net = None
    if net_mode != "nonet":
        _, params_j = _jax_net(game, use_ln=net_mode == "ln")
        net = net_from_state_dict(from_flax(params_j), game)
    ref = Grid2PallasSolver(
        game=JLiarsDice(1, 4), params=JParams(**kw), lane_block=B,
        interpret=True,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, params_j)
    out = _port(game, SubgameSolvingParams(**kw), beliefs, t_stop, net)
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=1e-5, err_msg=name,
        )


def test_solve_reference_matches_pallas_bf16_fast_gelu():
    """bf16 operands with f32 accumulation and the polynomial GELU on both
    sides.  The two round the same operands to bf16, so they agree far
    inside the 2e-4 stated here (measured 0 to a few 1e-7)."""
    game = LiarsDice(1, 4)
    kw = dict(num_iters=10, max_depth=2, use_cfr=True, linear_update=True)
    beliefs, t_stop = _inputs(game, 6, kw["num_iters"])
    _, params_j = _jax_net(game, use_ln=True)
    net = net_from_state_dict(from_flax(params_j), game)
    ref = Grid2PallasSolver(
        game=JLiarsDice(1, 4), params=JParams(**kw), lane_block=B,
        net_compute_dtype=jnp.bfloat16, interpret=True,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, params_j)
    out = _port(game, SubgameSolvingParams(**kw), beliefs, t_stop, net,
                dtype=torch.bfloat16)
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=2e-4, err_msg=name,
        )


@pytest.mark.parametrize("num_faces", [3, 4])
def test_grid2b_step_matches_jax_grid2b(num_faces):
    """Five CFR steps of the plain batch-last solver with the net at the
    flax numerics (exact erf GELU, two-pass LayerNorm) against the JAX
    grid2b: state tensors at 1e-5."""
    game = LiarsDice(1, num_faces)
    jgame = JLiarsDice(1, num_faces)
    kw = dict(num_iters=5, max_depth=2, use_cfr=True, linear_update=True)
    rng = np.random.RandomState(num_faces)
    nb = 4
    bids = np.array([-1, 0, 2, game.num_actions - 2], np.int32)
    players = np.array([0, 1, 1, 0], np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(2, nb)).astype(
        np.float32
    ).transpose(0, 2, 1)  # [2, H, B]
    spec, params_j = _jax_net(game, use_ln=True, seed=5)
    net = net_from_state_dict(from_flax(params_j), game)

    jsolver = JGrid2B(game=jgame, params=JParams(**kw), dtype=jnp.float32,
                      net_params=params_j)
    jroot = JRootCtxB.of(jgame, bids, players)
    jstate = jsolver.init(jroot, jnp.asarray(beliefs))

    solver = Grid2BatchSolver(game=game, params=SubgameSolvingParams(**kw),
                              mlp=lambda x: net(x.T).T, device="cpu")
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
            atol=1e-5, err_msg=name,
        )


def test_solve_on_cpu_takes_plain_version_without_launching():
    game = LiarsDice(1, 4)
    sub = SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=True,
                               linear_update=True)
    beliefs, t_stop = _inputs(game, 1, sub.num_iters)
    args = (game, sub, torch.as_tensor(BIDS), torch.as_tensor(PLAYERS),
            torch.as_tensor(beliefs), torch.as_tensor(t_stop), None)
    before = grid2p.solve.launches
    out = grid2p.solve(*args)
    ref = grid2p.solve_reference(*args)
    assert grid2p.solve.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_solve_refuses_fictitious_play():
    """Fictitious play is refused only where CFR is too (a depth other
    than 2); at depth 2 the fused solve takes it."""
    game = LiarsDice(1, 4)
    beliefs, t_stop = _inputs(game, 1, 2)
    args = (torch.as_tensor(BIDS), torch.as_tensor(PLAYERS),
            torch.as_tensor(beliefs), torch.as_tensor(t_stop))
    deep = SubgameSolvingParams(num_iters=2, max_depth=3, use_cfr=False)
    with pytest.raises(ValueError, match="depth-2"):
        grid2p.solve(game, deep, *args)
    out = grid2p.solve(game, deep.replace(max_depth=2), *args)
    assert all(bool(torch.isfinite(x).all()) for x in out)


def test_pseudo_leaf_pairs_match_pallas():
    game = LiarsDice(1, 4)
    jsolver = Grid2PallasSolver(
        game=JLiarsDice(1, 4),
        params=JParams(num_iters=1, max_depth=2, use_cfr=True),
    )
    np.testing.assert_array_equal(grid2p.pseudo_leaf_pairs(game),
                                  jsolver.pairs)
    assert len(jsolver.pairs) == 28  # C(A-1, 2) at 1x4f
