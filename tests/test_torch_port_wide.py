"""Nets of width 257-512 in the port's fused solve: the kernel's wide units.

A net wider than 256 runs at the padded width 512 (``grid2p.WIDE_WIDTH``)
in four instantiations of their own (``kernels/grid2_cfr.cu`` units
``WIDE_UNIT0`` on: f32 and bf16, CFR and FP; the bf16 MLP with both
warpgroups of a block on one 64-row tile, its hidden layers on the bf16
ring); narrower nets keep the units, plans and bits they had.  The
kernels run on the card only (``chip_smoke.py`` phase ``widths``); here,
on the CPU:

(a) the port's fused solve (its plain version, which the wrapper takes for
    CPU tensors and the card holds the wide units to) against the JAX
    package's Pallas kernel in interpret mode, at widths 300, 384 and 512,
    1-3 hidden layers, CFR and FP, with and without LayerNorm, at
    ``tests/test_torch_port_fp.py``'s tolerance (atol 1e-5);
(b) is ``tests/test_torch_port_widths.py``'s packing test, whose cases
    take widths 300, 384 and 512 too;
(c) the plans at width 512 for every game of ``eval_all``'s defaults,
    CFR and FP, bf16 and f32, and the shared-memory reckoning of both MLPs;
(d) what the wide units do not take raises in ``kernel_plan`` and
    ``choose_lane_block`` before any build or launch, naming ROADMAP
    Queue 6; and ``_force_width``, which runs narrower nets on them;
(e) the run entry trains a net of width 300 (the CPU: the plain version).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

B = 8
CONF = str(pathlib.Path(__file__).resolve().parents[1] / "conf"
           / "liars_sp.yaml")


def _jax_net(game, n_hidden, n_layers, use_ln, seed):
    """A JAX net of the given shape from a seed, LayerNorm's scale and bias
    drawn with numpy (not 1 and 0), as numpy arrays."""
    spec = CFVNetSpec(game=JLiarsDice(game.num_dice, game.num_faces),
                      n_hidden=n_hidden, n_layers=n_layers,
                      use_layer_norm=use_ln)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for name, leaf in params["params"].items():
        if name.startswith("LayerNorm"):
            leaf["scale"] = rng.uniform(0.5, 1.5, leaf["scale"].shape) \
                .astype(np.float32)
            leaf["bias"] = rng.uniform(-0.5, 0.5, leaf["bias"].shape) \
                .astype(np.float32)
    return params


# (a) (game, solver, width, hidden layers, LayerNorm): widths 300, 384 and
# 512 at 1, 2 and 3 hidden layers, CFR and FP, with and without LayerNorm.
SOLVE_CASES = [
    ((1, 3), "cfr", 300, 1, True), ((1, 3), "fp", 384, 2, False),
    ((1, 3), "cfr", 512, 3, False), ((1, 3), "fp", 512, 1, True),
    ((1, 4), "cfr", 512, 2, True), ((1, 4), "fp", 300, 3, True),
    ((1, 4), "cfr", 384, 1, False), ((1, 4), "fp", 512, 2, True),
]


@pytest.mark.parametrize("dims,solver,width,layers,use_ln", SOLVE_CASES)
def test_wide_solve_matches_pallas(dims, solver, width, layers, use_ln):
    """(a): the plain version of the fused solve against the Pallas kernel
    in interpret mode, on the same seeded inputs and the same net."""
    game = LiarsDice(*dims)
    kw = dict(num_iters=6, max_depth=2, use_cfr=solver == "cfr",
              linear_update=True)
    rng = np.random.RandomState(width + layers)
    bids = rng.randint(-1, game.num_actions - 1, size=B).astype(np.int32)
    players = rng.randint(0, 2, size=B).astype(np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(B, 2)).astype(
        np.float32)
    t_stop = rng.randint(0, kw["num_iters"] + 1, size=B).astype(np.int32)
    t_stop[:2] = (0, kw["num_iters"])
    params_j = _jax_net(game, width, layers, use_ln, seed=layers)
    net = net_from_state_dict(from_flax(params_j), game)
    assert (net.n_hidden, net.n_layers) == (width, layers)
    assert grid2p.padded_width(width) == grid2p.WIDE_WIDTH
    ref = Grid2PallasSolver(
        game=JLiarsDice(*dims), params=JParams(**kw), lane_block=B,
        interpret=True,
    ).solve(bids, players, beliefs, t_stop, params_j)
    out = grid2p.solve(
        game, SubgameSolvingParams(**kw), torch.as_tensor(bids),
        torch.as_tensor(players), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net)
    for name in ("rvm", "snap0", "snap1"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            atol=1e-5, err_msg=name)


def _params(use_cfr, optimistic=False):
    return SubgameSolvingParams(num_iters=8, max_depth=2, use_cfr=use_cfr,
                                linear_update=True, optimistic=optimistic)


def _net(game, width=512, layers=2, use_ln=True):
    return CFVNet(game, width, layers, use_ln,
                  generator=torch.Generator().manual_seed(0))


# (c) The lane block a 512x2 net takes at 1024 lanes: bf16, f32.
WIDE_LANE_BLOCKS = {(1, 4): (8, 8), (1, 5): (4, 8), (1, 6): (4, 4),
                    (2, 3): (1, 2)}


@pytest.mark.parametrize("use_cfr", [True, False])
@pytest.mark.parametrize("dims", list(WIDE_LANE_BLOCKS))
def test_wide_plan_table(dims, use_cfr):
    """(c): at every game of ``eval_all``'s defaults a 512x2 net takes the
    wide unit of its operands and solver at the largest lane block that
    fits shared memory without the workspace (bf16: the hidden layer on
    the ring; f32: the first layer resident), and so do nets of 300 and
    384 (the same padded width); one hidden layer has no ring.  Optimistic
    FP fits too."""
    game = LiarsDice(*dims)
    params = _params(use_cfr)
    for dtype, want in zip((torch.bfloat16, torch.float32),
                           WIDE_LANE_BLOCKS[dims]):
        bf16 = dtype == torch.bfloat16
        plans = []
        for width in (300, 384, 512):
            net = _net(game, width)
            lb = grid2p.choose_lane_block(game, params, net, dtype, 1024)
            plan = grid2p.kernel_plan(game, params, net, dtype, 1024, lb)
            assert lb == want, (width, dtype)
            assert (plan.width, plan.ring, plan.workspace, plan.groups) == (
                grid2p.WIDE_WIDTH, bf16, 0, 1)
            assert plan.layout == ("ring@512" if bf16 else "resident@512")
            assert plan.smem <= grid2p.SMEM_LIMIT
            assert grid2p.kernel_unit(params, plan, True) == (
                grid2p.WIDE_UNIT0 + 2 * bf16 + (not use_cfr))
            plans.append(plan)
        assert plans[0] == plans[1] == plans[2]
        one = grid2p.kernel_plan(game, params, _net(game, 512, 1), dtype,
                                 1024, want)
        assert not one.ring and one.layout == "resident@512"
        if not use_cfr:
            opt = _params(False, optimistic=True)
            lb = grid2p.choose_lane_block(game, opt, _net(game), dtype, 1024)
            assert grid2p.kernel_plan(game, opt, _net(game), dtype, 1024,
                                      lb).smem <= grid2p.SMEM_LIMIT


def test_wide_smem_reckoning():
    """(c): 1x4f, lane block 8, CFR, 512x2.  bf16: the first layer (32 x
    512) and the head (8 x 512) resident with their barrier (16 B; the f32
    parameters stay in device memory), the tile's A operand (64 x 512
    bf16) and LayerNorm's sums of each half (2 x 64 x 2 f32), two ring
    stages of 32 k rows of 512 columns (32 KB each) with their barriers and
    counts.  f32: the first layer [20, 512], 4 rows a warp of 512 f32, two
    ring stages of 8 rows (16 KB each).  The lanes' state is the 256x2
    net's."""
    game = LiarsDice(1, 4)
    bf16 = grid2p.smem_layout(game, 8, True, 512, 2, True, ring=True)
    assert bf16["mlp"] == (32 + 8) * 512 * 2 + 16
    assert bf16["tile"] == 64 * 512 * 2 + 2 * 64 * 2 * 4
    assert bf16["ring"] == 2 * 32 * 512 * 2 + 32
    narrow = grid2p.smem_layout(game, 8, True, 256, 2, True)
    assert bf16["lanes"] == narrow["lanes"]
    assert bf16["tables"] == narrow["tables"]
    assert bf16["total"] == sum(v for k, v in bf16.items() if k != "total")
    assert bf16["total"] == 209312 <= grid2p.SMEM_LIMIT
    f32 = grid2p.smem_layout(game, 8, True, 512, 2, False)
    assert f32["mlp"] == 20 * 512 * 4 + 16
    assert f32["rows"] == 8 * 4 * 512 * 4
    assert f32["ring"] == 2 * 8 * 512 * 4 + 32
    assert "tile" not in f32 and f32["total"] == 175520
    # Deeper nets: the same ring, no more shared memory.
    assert grid2p.smem_layout(game, 8, True, 512, 6, True, ring=True) == bf16
    with pytest.raises(ValueError, match="one group"):
        grid2p.smem_layout(game, 8, True, 512, 2, True, groups=2, ring=True)
    with pytest.raises(ValueError, match="without the workspace"):
        grid2p.smem_layout(game, 8, True, 512, 2, False,
                           workspace=grid2p.WS_BODY)


def test_default_mlp_chunks_at_the_wide_width():
    """A turn of the wide bf16 MLP is one 64-row tile (both warpgroups on
    it), of the wide f32 MLP 32 rows (4 a warp): one group of pairs
    still takes the fewest turns at 1x4f and 2x3f."""
    for dims, lb in (((1, 4), 8), ((2, 3), 1), ((1, 6), 4)):
        P = len(grid2p.pseudo_leaf_pairs(LiarsDice(*dims)))
        for mma in (True, False):
            assert grid2p.default_mlp_chunks(P, lb, 1, mma, 512) == 1
    assert grid2p.warp_rows(512) * grid2p.WARPS == 32


# (d) What the wide units do not take: (game, net width, operands,
# interleave, what the message names).
REFUSED = [((2, 6), 300, torch.bfloat16, 1, "workspace"),
           ((2, 6), 512, torch.float32, 1, "workspace"),
           ((1, 16), 384, torch.float32, 1, "workspace"),
           ((2, 5), 512, torch.bfloat16, 1, "workspace"),
           ((2, 5), 512, torch.float32, 1, "fits no lane block"),
           ((1, 4), 300, torch.bfloat16, 2, "interleave=2"),
           ((2, 3), 512, torch.float32, 2, "interleave=2")]


@pytest.mark.parametrize("dims,width,dtype,interleave,match", REFUSED)
def test_wide_refusals_raise_before_any_launch(dims, width, dtype,
                                               interleave, match):
    """(d): a wide net on a game whose rows or bf16 first layer only the
    workspace holds, or whose state fits no lane block without it, and
    ``interleave=2`` with a wide CFR net raise in ``kernel_plan`` and
    ``choose_lane_block``, naming ROADMAP Queue 6, before anything is
    built or launched."""
    game = LiarsDice(*dims)
    net = _net(game, width)
    launches = grid2p.solve.launches
    for call in (
            lambda: grid2p.kernel_plan(game, _params(True), net, dtype,
                                       1024, 2, interleave=interleave),
            lambda: grid2p.choose_lane_block(game, _params(True), net,
                                             dtype, 1024,
                                             interleave=interleave)):
        with pytest.raises(ValueError, match=match) as err:
            call()
        assert "ROADMAP Queue 6" in str(err.value)
    assert grid2p.solve.launches == launches


def test_wide_fp_with_interleave_runs_as_one_group():
    """FP never takes the two-group kernel: with ``interleave=2`` a wide
    FP net runs as ``interleave=1`` on its wide unit."""
    game = LiarsDice(1, 4)
    plan = grid2p.kernel_plan(game, _params(False), _net(game, 300),
                              torch.bfloat16, 1024, 8, interleave=2)
    assert (plan.groups, plan.width) == (1, grid2p.WIDE_WIDTH)


def test_forced_width_runs_narrow_nets_on_the_wide_units():
    """``grid2p._force_width(512)`` (the checks that hold the wide units to
    the others on the repo's 256x2 nets): the plan of a 256x2 net is a wide
    one, and outside the block it is the narrow one again; a forced
    workspace does not go with it; the plain version's bits do not depend
    on it."""
    game = LiarsDice(1, 4)
    net = _net(game, 256)
    params = _params(True)
    narrow = grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024, 8)
    assert narrow.width == grid2p.KERNEL_WIDTH
    with grid2p._force_width(grid2p.WIDE_WIDTH):
        lb = grid2p.choose_lane_block(game, params, net, torch.bfloat16, 1024)
        wide = grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024,
                                  lb)
        assert (lb, wide.width, wide.layout) == (8, 512, "ring@512")
        assert wide == grid2p.kernel_plan(game, params, _net(game, 512),
                                          torch.bfloat16, 1024, 8)
        with grid2p._force_workspace(grid2p.WS_BODY):
            with pytest.raises(ValueError, match="Queue 6"):
                grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024,
                                   8)
    assert grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024,
                              8) == narrow
    with pytest.raises(ValueError, match="padded width"):
        with grid2p._force_width(384):
            pass
    rng = np.random.RandomState(3)
    args = (game, _params(True), torch.as_tensor(rng.randint(-1, 8, size=B)),
            torch.as_tensor(rng.randint(0, 2, size=B)),
            torch.as_tensor(rng.dirichlet(np.ones(4), size=(B, 2))
                            .astype(np.float32)),
            torch.as_tensor(rng.randint(0, 9, size=B)), net, torch.bfloat16)
    want = grid2p.solve(*args)
    with grid2p._force_width(grid2p.WIDE_WIDTH):
        got = grid2p.solve(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_run_entry_trains_a_wide_net_on_the_cpu(tmp_path):
    """(e): ``python -m rebel_tpu_torch.run`` with
    ``model.kwargs.n_hidden=300`` trains through the same paths that take
    the wide units on the card (the CPU: the plain version), writes
    ``.params`` of that width, and on the card its generation would run
    ``grid2_cfr`` at the padded width 512."""
    import json

    from rebel_tpu_torch import run

    out = run.execute([
        "--cfg", CONF, "--device", "cpu", "--exp_dir",
        str(tmp_path), "--mode", "gentle_start", "selfplay.batch=8",
        "data.train_epoch_size=64", "data.train_batch_size=16",
        "env.num_faces=3", "env.subgame_params.num_iters=4",
        "model.kwargs.n_hidden=300", "model.kwargs.n_layers=2",
        "replay.capacity=512", "exploit=false", "checkpoint_every=1",
        "max_epochs=1", "selfplay.net_compute_dtype=bf16",
        "env.subgame_params.use_cfr=true"])
    tr = out.trainer
    assert (tr.net.n_hidden, tr.net.n_layers) == (300, 2)
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0]
    assert np.isfinite(json.loads(lines[0])["loss/train"])
    assert (tmp_path / "ckpt" / "epoch0.params").exists()
    sub = tr.cfg.env.subgame_params
    lb = grid2p.choose_lane_block(tr.game, sub, tr.net,
                                  tr.cfg.net_compute_dtype, 1024)
    plan = grid2p.kernel_plan(tr.game, sub, tr.net, tr.cfg.net_compute_dtype,
                              1024, lb)
    assert (plan.width, plan.ring) == (grid2p.WIDE_WIDTH, True)
    assert grid2p.kernel_name(sub) == "grid2_cfr"
