"""The port's game tables, solver helpers, value net and weight carriage
against the JAX package on the CPU, and the port's isolation from JAX.

Inputs come from a numpy seed and cross as numpy arrays.  The test
session enables x64, so every JAX input is cast to f32 explicitly.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.nets.torch_import import (
    build_torch_net2,
    net2_state_dict_to_params,
    params_to_net2_state_dict,
)
from rebel_tpu.solving import core as jcore
from rebel_tpu.solving.params import SubgameSolvingParams as JParams
from rebel_tpu.tree import root_action_mask as jroot_action_mask

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.nets.convert import (
    from_flax,
    load_net2,
    net_from_state_dict,
    save_net2,
    to_flax,
)
from rebel_tpu_torch.solving import core
from rebel_tpu_torch.solving.params import SubgameSolvingParams

REPO = pathlib.Path(__file__).resolve().parents[1]
GAMES = [(1, 3), (1, 4), (2, 3)]


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


# ------------------------------------------------------------- (a) game
@pytest.mark.parametrize("dice,faces", GAMES)
def test_game_tables_equal_jax(dice, faces):
    g, jg = LiarsDice(dice, faces), JLiarsDice(dice, faces)
    for name in ("num_actions", "num_hands", "liar_call", "query_size",
                 "total_num_dice", "wild_face"):
        assert getattr(g, name) == getattr(jg, name), name
    np.testing.assert_array_equal(g.matches_table, jg.matches_table)
    np.testing.assert_array_equal(g.terminal_payoff, jg.terminal_payoff)
    assert INITIAL_ACTION == -1
    for a in range(g.liar_call):
        assert g.unpack_action(a) == jg.unpack_action(a)


@pytest.mark.parametrize("dice,faces", GAMES)
def test_root_mask_and_root_query_equal_jax(dice, faces):
    g, jg = LiarsDice(dice, faces), JLiarsDice(dice, faces)
    rng = np.random.RandomState(faces)
    bids = np.arange(-1, g.num_actions - 1, dtype=np.int32)
    n = len(bids)
    players = rng.randint(0, 2, size=n).astype(np.int32)
    beliefs = rng.dirichlet(np.ones(g.num_hands), size=(n, 2)).astype(
        np.float32)
    beliefs[0, 1] = 0.0  # all-zero row: epsilon normalisation to uniform
    mask = core.root_action_mask(g, torch.as_tensor(bids).long()).numpy()
    for i, b in enumerate(bids):
        np.testing.assert_array_equal(mask[i], jroot_action_mask(jg, int(b)))
        ctx = core.RootCtx.of(g, torch.tensor(int(b)), torch.tensor(0))
        np.testing.assert_array_equal(ctx.mask.numpy(), mask[i])
    for trav in (0, 1):
        jq = jax.vmap(
            lambda bel, b, p: jcore.root_query(jg, jnp.float32, bel, trav, b,
                                               p)
        )(jnp.asarray(beliefs), jnp.asarray(bids), jnp.asarray(players))
        q = core.root_query(g, torch.as_tensor(beliefs), trav,
                            torch.as_tensor(bids).long(),
                            torch.as_tensor(players).long())
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(linear_update=True),
    dict(dcfr=True, dcfr_alpha=1.5, dcfr_beta=0.5, dcfr_gamma=2.0),
    dict(dcfr=True, dcfr_alpha=5.0, dcfr_beta=-5.0, dcfr_gamma=1.0),
    dict(),
], ids=["linear", "dcfr", "dcfr_clamped", "plain"])
def test_cfr_discounts_equal_jax(kw):
    p = SubgameSolvingParams(use_cfr=True, **kw)
    jp = JParams(use_cfr=True, **kw)
    for n in (1.0, 2.0, 7.0, 512.0):
        port = core.cfr_discounts(p, n)
        ref = jcore.cfr_discounts(jp, jnp.float32(n), jnp.float32)
        np.testing.assert_allclose([float(x) for x in port],
                                   [float(x) for x in ref], rtol=1e-6)
    assert core.reach_eps(torch.float32) == jcore.reach_eps(jnp.float32)
    assert core.regret_eps(torch.float32) == jcore.regret_eps(jnp.float32)


def test_params_refuse_linear_with_dcfr():
    with pytest.raises(ValueError):
        SubgameSolvingParams(use_cfr=True, linear_update=True, dcfr=True)
    assert SubgameSolvingParams(num_iters=3).replace(num_iters=5).num_iters \
        == 5


# ---------------------------------------------------------- (b) the net
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_cfv_net_equals_flax(use_ln, n_layers):
    g = LiarsDice(1, 4)
    spec = CFVNetSpec(game=JLiarsDice(1, 4), n_hidden=16, n_layers=n_layers,
                      use_layer_norm=use_ln)
    params = _f32(spec.init_params(jax.random.PRNGKey(3)))
    x = np.random.RandomState(0).randn(32, g.query_size).astype(np.float32)
    ref = np.asarray(spec.module.apply(params, jnp.asarray(x)))
    net = net_from_state_dict(from_flax(params), g)
    assert (net.n_layers, net.n_hidden, net.use_layer_norm) == (
        n_layers, 16, use_ln)
    with torch.no_grad():
        out = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_convert_round_trips_and_matches_torch_import():
    g = LiarsDice(1, 4)
    spec = CFVNetSpec(game=JLiarsDice(1, 4), n_hidden=16, n_layers=2)
    params = _f32(spec.init_params(jax.random.PRNGKey(4)))
    sd = from_flax(params)
    back = to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # The JAX package's own Net2 mapping reads and writes the same dict.
    ref_sd = params_to_net2_state_dict(params, spec)
    assert set(ref_sd) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), ref_sd[k].numpy())
    theirs = net2_state_dict_to_params(CFVNet(g, 16, 2).state_dict(), spec)
    assert jax.tree.structure(theirs) == jax.tree.structure(params)
    # The reference Net2 module loads the port's state dict as it is.
    net2 = build_torch_net2(spec)
    net2.load_state_dict(CFVNet(g, 16, 2).state_dict())


def test_net2_save_load(tmp_path):
    g = LiarsDice(1, 4)
    net = CFVNet(g, 16, 2, generator=torch.Generator().manual_seed(1))
    save_net2(net, tmp_path / "net.pt")
    back = load_net2(tmp_path / "net.pt", g, device="cpu")
    for (ka, a), (kb, b) in zip(net.state_dict().items(),
                                back.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_cfv_net_init_is_seeded_and_head_scaled():
    g = LiarsDice(1, 4)
    a = CFVNet(g, 64, 2, generator=torch.Generator().manual_seed(5))
    b = CFVNet(g, 64, 2, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    bound = 1.0 / np.sqrt(64)
    assert float(a.output.weight.detach().abs().max()) <= 0.01 * bound
    first = a.body[0].weight.detach()
    assert float(first.abs().max()) <= 1.0 / np.sqrt(g.query_size)
    assert [type(m).__name__ for m in a.body[:4]] == [
        "Linear", "LayerNorm", "GELU", "Sequential"]
    assert a.body[1].eps == 1e-5 and a.body[2].approximate == "none"


# ---------------------------------------------------- (h) no JAX inside
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rebel_tpu")


def _port_sources():
    files = sorted((REPO / "rebel_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_port_loads_no_jax_in_a_fresh_process():
    code = (
        "import sys, pkgutil, importlib, rebel_tpu_torch\n"
        "for m in pkgutil.walk_packages(rebel_tpu_torch.__path__,"
        " 'rebel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, capture_output=True)


def test_cuda_without_cuda_raises(tmp_path, monkeypatch):
    """Asking for the card where there is none, or building without
    ``nvcc``, raises; nothing falls back to the plain version."""
    if torch.cuda.is_available() or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this checks the refusals on a machine without CUDA")
    from rebel_tpu_torch.kernels import build
    from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
    from rebel_tpu_torch.solving import grid2p
    from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig

    sub = SubgameSolvingParams(num_iters=2, use_cfr=True, linear_update=True)
    cfg = TrainerConfig(env=RecursiveSolvingParams(subgame_params=sub),
                        n_hidden=16, selfplay_batch=8, replay_capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, device="cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("grid2_cfr")
    launches = grid2p.solve.launches
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        grid2p.solve(LiarsDice(1, 4), sub,
                     torch.zeros(8, dtype=torch.long, **meta),
                     torch.zeros(8, dtype=torch.long, **meta),
                     torch.full((8, 2, 4), 0.25, **meta),
                     torch.zeros(8, dtype=torch.long, **meta))
    assert grid2p.solve.launches == launches
