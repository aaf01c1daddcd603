"""The options of the port's fused solve against the JAX package's, on
the CPU.

``solve_reference`` (the plain version of the CUDA kernel) takes the
options of ``Grid2PallasSolver``: ``gelu``, ``ablate``, ``mlp_chunks`` and
``interleave``.  Each is held against the Pallas kernel in interpret mode
with the same option at the tolerances of ``test_torch_port_grid2.py``:
atol 1e-5 in f32 and 2e-4 with bf16 operands.  Inputs come from a numpy
seed and go to both packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

B = 8
BIDS = np.array([-1, 0, 2, 5, -1, 3, 6, 7], np.int32)
PLAYERS = np.array([0, 1, 0, 1, 1, 0, 1, 0], np.int32)
KW = dict(num_iters=8, max_depth=2, use_cfr=True, linear_update=True)
GAME = LiarsDice(1, 4)
JGAME = JLiarsDice(1, 4)
F32, BF16 = "f32", "bf16"
DTYPES = {F32: (torch.float32, jnp.float32, 1e-5),
          BF16: (torch.bfloat16, jnp.bfloat16, 2e-4)}


def _inputs(seed, num_iters=KW["num_iters"]):
    rng = np.random.RandomState(seed)
    beliefs = rng.dirichlet(np.ones(GAME.num_hands), size=(B, 2)).astype(
        np.float32)
    t_stop = rng.randint(0, num_iters + 1, size=B).astype(np.int32)
    t_stop[:2] = (0, num_iters)
    return beliefs, t_stop


def _nets(use_ln=True, seed=2):
    spec = CFVNetSpec(game=JGAME, n_hidden=16, n_layers=2,
                      use_layer_norm=use_ln)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(seed)))
    return params, net_from_state_dict(from_flax(params), GAME)


def _port(beliefs, t_stop, net, dtype=torch.float32, kw=KW, **knobs):
    return grid2p.solve_reference(
        GAME, SubgameSolvingParams(**kw), torch.as_tensor(BIDS),
        torch.as_tensor(PLAYERS), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net, dtype, **knobs)


def _pallas(beliefs, t_stop, params, dtype=jnp.float32, kw=KW, **knobs):
    return Grid2PallasSolver(
        game=JGAME, params=JParams(**kw), lane_block=B,
        net_compute_dtype=dtype, interpret=True, **knobs,
    ).solve(BIDS, PLAYERS, beliefs, t_stop, params)


def _assert_close(out, ref, atol):
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("gelu", grid2p.GELUS)
def test_gelu_policy_matches_pallas(gelu, dtype):
    tdt, jdt, atol = DTYPES[dtype]
    beliefs, t_stop = _inputs(11)
    params, net = _nets()
    _assert_close(_port(beliefs, t_stop, net, tdt, gelu=gelu),
                  _pallas(beliefs, t_stop, params, jdt, gelu=gelu), atol)


@pytest.mark.parametrize("use_ln", [True, False], ids=["ln", "no_ln_net"])
@pytest.mark.parametrize("ablate", grid2p.ABLATIONS[1:])
def test_ablate_matches_pallas(ablate, use_ln):
    beliefs, t_stop = _inputs(12)
    params, net = _nets(use_ln)
    _assert_close(_port(beliefs, t_stop, net, ablate=ablate),
                  _pallas(beliefs, t_stop, params, ablate=ablate), 1e-5)


def test_ablate_matches_pallas_bf16():
    """The benchmark's setting: an ablation with bf16 operands."""
    tdt, jdt, atol = DTYPES[BF16]
    beliefs, t_stop = _inputs(13)
    params, net = _nets()
    _assert_close(_port(beliefs, t_stop, net, tdt, ablate="noln"),
                  _pallas(beliefs, t_stop, params, jdt, ablate="noln"), atol)


@pytest.mark.parametrize("mlp_chunks", [1, 2, 4, 28])
def test_mlp_chunks_matches_pallas(mlp_chunks):
    beliefs, t_stop = _inputs(14)
    params, net = _nets()
    out = _port(beliefs, t_stop, net, mlp_chunks=mlp_chunks)
    _assert_close(out, _pallas(beliefs, t_stop, params,
                               mlp_chunks=mlp_chunks), 1e-5)
    # The grouping changes no lane's arithmetic beyond the product's
    # blocking.
    for a, b in zip(out, _port(beliefs, t_stop, net)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6,
                                   rtol=1e-5)


def test_interleave_matches_pallas():
    beliefs, t_stop = _inputs(15)
    params, net = _nets()
    out = _port(beliefs, t_stop, net, interleave=2)
    _assert_close(out, _pallas(beliefs, t_stop, params, interleave=2), 1e-5)
    # Per-lane results equal interleave=1, at the tolerance the JAX
    # package holds its own kernel to.
    for a, b in zip(out, _port(beliefs, t_stop, net)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6,
                                   rtol=1e-5)
    # Half-blocks of a lane block of 4: lanes (0, 1, 4, 5) and (2, 3, 6, 7).
    for a, b in zip(out, _port(beliefs, t_stop, net, interleave=2,
                               lane_block=4, mlp_chunks=4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["fp", "nonet"])
def test_interleave_falls_back_where_the_reference_does(mode):
    """Fictitious play and the no-net mode run as ``interleave=1`` (and an
    odd lane block is then no error), under their own kernel's name."""
    kw = dict(KW, use_cfr=mode != "fp")
    beliefs, t_stop = _inputs(16)
    params, net = _nets() if mode == "fp" else (None, None)
    out = _port(beliefs, t_stop, net, kw=kw, interleave=2, lane_block=1)
    for a, b in zip(out, _port(beliefs, t_stop, net, kw=kw)):
        assert torch.equal(a, b)
    _assert_close(out, _pallas(beliefs, t_stop, params, kw=kw, interleave=2),
                  1e-5)
    sub = SubgameSolvingParams(**kw)
    assert grid2p.effective_interleave(sub, net is not None, 2, 3) == 1
    assert grid2p.kernel_name(sub, net is not None, 2) == (
        "grid2_fp" if mode == "fp" else "grid2_cfr")


def test_kernel_names():
    cfr = SubgameSolvingParams(**KW)
    assert grid2p.kernel_name(cfr) == "grid2_cfr"
    assert grid2p.kernel_name(cfr, True, 2) == "grid2_cfr_il2"
    assert grid2p.kernel_name(cfr.replace(use_cfr=False)) == "grid2_fp"
    assert set(grid2p.solve.launches_by_kernel) == {
        "grid2_cfr", "grid2_fp", "grid2_cfr_il2"}


@pytest.mark.parametrize(
    "dtype,gelu,ablate,want",
    [(torch.float32, "auto", "", "exact"),
     (torch.bfloat16, "auto", "", "fast"),
     (torch.bfloat16, "exact", "", "exact"),
     (torch.float32, "fast", "", "fast"),
     (torch.float32, "exact", "cheaperf", "fast"),
     (torch.float32, "exact", "noln", "exact"),
     (torch.bfloat16, "auto", "noln", "fast"),
     (torch.bfloat16, "fast", "nogelu", "identity")])
def test_activation_precedence(dtype, gelu, ablate, want):
    assert grid2p.activation(dtype, gelu, ablate) == want


def test_cheaperf_wins_over_exact_gelu():
    beliefs, t_stop = _inputs(17)
    params, net = _nets()
    both = _port(beliefs, t_stop, net, gelu="exact", ablate="cheaperf")
    fast = _port(beliefs, t_stop, net, gelu="fast")
    exact = _port(beliefs, t_stop, net, gelu="exact")
    assert all(torch.equal(a, b) for a, b in zip(both, fast))
    assert not torch.equal(both.rvm, exact.rvm)
    _assert_close(both, _pallas(beliefs, t_stop, params, gelu="exact",
                                ablate="cheaperf"), 1e-5)


def test_noln_keeps_scale_and_bias():
    """``noln`` skips the statistics only: with a scale of 2 and a bias of
    1 the result differs from the same net without LayerNorm layers."""
    beliefs, t_stop = _inputs(18)
    _, net = _nets(True)
    _, bare = _nets(False)
    bare.load_state_dict({k: v for k, v in net.state_dict().items()
                          if k in bare.state_dict()})
    for _, ln in net.hidden_layers():
        ln.weight.data.fill_(2.0)
        ln.bias.data.fill_(1.0)
    x = torch.as_tensor(np.random.RandomState(0).rand(GAME.query_size, 5),
                        dtype=torch.float32)
    with torch.no_grad():
        got = grid2p.kernel_mlp(net, ablate="noln")(x)
        plain = grid2p.kernel_mlp(bare)(x)
        h = x.T
        for lin, _ in net.hidden_layers():
            h = grid2p.gelu_erf((h @ lin.weight.T + lin.bias) * 2.0 + 1.0)
        want = (h @ net.output.weight.T + net.output.bias).T
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert not torch.allclose(got, plain, atol=1e-4)


@pytest.mark.parametrize(
    "knobs,match",
    [(dict(gelu="tanh"), "gelu"),
     (dict(ablate="nothing"), "ablate"),
     (dict(interleave=3), "interleave"),
     (dict(interleave=0), "interleave"),
     (dict(interleave=2, lane_block=1), "odd"),
     (dict(interleave=2, lane_block=3), "odd"),
     (dict(mlp_chunks=0), "mlp_chunks")])
@pytest.mark.parametrize("entry", ["solve", "solve_reference"])
def test_bad_knobs_raise(entry, knobs, match):
    beliefs, t_stop = _inputs(19)
    _, net = _nets()
    fn = getattr(grid2p, entry)
    with pytest.raises(ValueError, match=match):
        fn(GAME, SubgameSolvingParams(**KW), torch.as_tensor(BIDS),
           torch.as_tensor(PLAYERS), torch.as_tensor(beliefs),
           torch.as_tensor(t_stop), net, **knobs)
