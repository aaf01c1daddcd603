"""Nets of any width up to 256 and any depth in the port's fused solve.

The kernel (``kernels/grid2_cfr.cu``) runs every net of width 1-256 at the
padded width 256 (``grid2p.KERNEL_WIDTH``), every layer padded with zero
columns; bf16 nets whose hidden matrices do not fit shared memory stream
them through a ring of slabs (nets of 257-512 run in the kernel's wide
units: ``tests/test_torch_port_wide.py``).  It runs on the card only
(``chip_smoke.py`` phase ``widths``); here, on the CPU:

(a) the port's fused solve (its plain version, which the wrapper takes for
    CPU tensors and the card holds the kernel to) against the JAX
    package's Pallas kernel in interpret mode, at widths 16-256 and 1-4
    hidden layers, CFR and FP, with and without LayerNorm, at
    ``tests/test_torch_port_fp.py``'s tolerances;
(b) the MLP as the kernel reads it, at the padded width, from the bf16
    block (resident and ring order) and from the f32 rows, against
    ``CFVNet`` at its own width;
(c) what ``kernel_plan`` and ``choose_lane_block`` pick at every game of
    ``eval_all``'s defaults, and the shared-memory reckoning of both
    layouts;
(d) the nets of ``chip_smoke.py``'s ring-bits check, which holds the ring
    to the resident weights bit for bit on deep nets: the plain version
    gives both the same bits.
"""

import importlib.util

import itertools
import pathlib
import re

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
ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL = ROOT / "rebel_tpu_torch" / "kernels" / "grid2_cfr.cu"


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


# (a) (game, solver, width, hidden layers, LayerNorm): every width of
# 16, 48, 100 and 256 and every depth of 1, 3 and 4 at both games, CFR
# and FP, with and without LayerNorm.
SOLVE_CASES = [
    ((1, 3), "cfr", 16, 1, True), ((1, 3), "fp", 48, 3, False),
    ((1, 3), "cfr", 100, 4, True), ((1, 3), "fp", 256, 1, True),
    ((1, 3), "cfr", 256, 3, False), ((1, 3), "fp", 16, 4, True),
    ((1, 4), "cfr", 48, 1, False), ((1, 4), "fp", 100, 3, True),
    ((1, 4), "cfr", 256, 4, True), ((1, 4), "fp", 16, 3, False),
    ((1, 4), "cfr", 100, 1, True), ((1, 4), "fp", 256, 4, False),
]


@pytest.mark.parametrize("dims,solver,width,layers,use_ln", SOLVE_CASES)
def test_solve_matches_pallas_at_any_width(dims, solver, width, layers,
                                           use_ln):
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


def _unpack(block, game, width, n_layers, ring):
    """The inverse of ``pack_mlp_weights(net, width, ring)``: the weights
    ``[N, K]`` (bf16, padding included) per layer and the f32
    parameters."""
    shapes = grid2p.mlp_block_shapes(game, width, n_layers)
    order = ([0, n_layers] + list(range(1, n_layers)) if ring
             else list(range(n_layers + 1)))
    weights, at = {}, 0

    def take(nbytes):
        nonlocal at
        at += nbytes
        return block[at - nbytes:at]

    for k in order[:2] if ring else order:
        n, kk = shapes[k]
        raw = take(2 * n * kk).view(torch.bfloat16)
        weights[k] = (raw.reshape(n // 8, kk // 8, 8, 8).permute(0, 2, 1, 3)
                      .reshape(n, kk))
    f32 = take(4 * (3 * n_layers * width + shapes[-1][0])).view(torch.float32)
    if ring:
        ks = grid2p.RING16_K
        for k in order[2:]:
            raw = take(2 * width * width).view(torch.bfloat16)
            slabs = raw.reshape(width // ks, width // 8, ks // 8, 8, 8)
            weights[k] = (slabs.permute(1, 3, 0, 2, 4)
                          .reshape(width, width))
    assert at == block.numel()
    return [weights[k] for k in range(n_layers + 1)], f32


def _mlp(x, weights, f32, width, real_width, n_layers, use_ln):
    """The MLP in f32 as the kernel computes it at the padded width: one-
    pass LayerNorm over the real width, the exact GELU; the head's first H
    columns.  ``weights``: ``[K, N]`` per layer (the product's)."""
    per = f32[:3 * n_layers * width].reshape(n_layers, 3, width)
    h = torch.nn.functional.pad(x, (0, weights[0].shape[0] - x.shape[1]))
    for k in range(n_layers):
        h = h @ weights[k] + per[k, 0]
        if use_ln:
            mu = h.sum(-1, keepdim=True) / real_width
            var = torch.clamp((h * h).sum(-1, keepdim=True) / real_width
                              - mu * mu, min=0.0)
            r = torch.rsqrt(var + 1e-5)
            h = (h * r - mu * r) * per[k, 1] + per[k, 2]
        h = grid2p.gelu_erf(h)
        # The padding columns stay exactly zero through every layer.
        assert not h[:, real_width:].any()
    return h @ weights[-1] + f32[3 * n_layers * width:][:weights[-1].shape[1]]


@pytest.mark.parametrize("real_width,n_layers,use_ln",
                         [(16, 1, True), (48, 3, False), (100, 4, True),
                          (200, 2, True), (256, 3, True), (300, 2, True),
                          (384, 3, False), (512, 1, True), (512, 2, True)])
def test_packed_mlp_at_the_padded_width_is_the_net(real_width, n_layers,
                                                   use_ln):
    """(b): the MLP that reads the wrapper's packing at the padded width
    (the bf16 block in both orders, and the f32 rows; 512 for nets wider
    than 256) is the net at its own width: bit for bit in its weights, to
    f32 rounding in its output."""
    game = LiarsDice(1, 4)
    net = CFVNet(game, real_width, n_layers, use_ln,
                 generator=torch.Generator().manual_seed(real_width))
    with torch.no_grad():  # bf16 weights, LayerNorm other than 1 and 0
        for lin in [lin for lin, _ in net.hidden_layers()] + [net.output]:
            lin.weight.copy_(lin.weight.to(torch.bfloat16).float())
        for _, ln in net.hidden_layers():
            if ln is not None:
                ln.weight.uniform_(0.5, 1.5)
                ln.bias.uniform_(-0.5, 0.5)
    width = grid2p.padded_width(real_width)
    H = game.num_hands
    x = torch.rand((40, game.query_size),
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = net(x)
    for ring in ([False, True] if n_layers > 1 else [False]):
        block = grid2p.pack_mlp_weights(net, width, ring)
        assert block.numel() == grid2p.mlp_block_bytes(game, width, n_layers)
        weights, f32 = _unpack(block, game, width, n_layers, ring)
        for w, lin in zip(weights, [lin for lin, _ in net.hidden_layers()]
                          + [net.output]):
            rows, cols = lin.weight.shape
            assert torch.equal(w[:rows, :cols].float(), lin.weight)
            assert not w[rows:].any() and not w[:, cols:].any()
        got = _mlp(x, [w.float().T for w in weights], f32, width,
                   real_width, n_layers, use_ln)[:, :H]
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    w0, hidden, head, f32 = grid2p.pack_f32_net(net, width)
    unrows = lambda w: w.permute(0, 1, 3, 2).reshape(w.shape[0], width)
    weights = [unrows(w0)]
    if n_layers > 1:
        weights += list(unrows(hidden).reshape(n_layers - 1, width, width))
    weights.append(head)
    assert hidden is None or hidden.shape[0] == (n_layers - 1) * width
    got = _mlp(x, weights, f32, width, real_width, n_layers, use_ln)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def _params(use_cfr):
    return SubgameSolvingParams(num_iters=8, max_depth=2, use_cfr=use_cfr,
                                linear_update=True)


def _net(game, width=256, layers=2):
    return CFVNet(game, width, layers, True,
                  generator=torch.Generator().manual_seed(0))


GAMES = [(1, 4), (1, 5), (1, 6), (2, 3)]
# The lane blocks every 256x2 net takes with its weights resident, as
# before the kernel took other shapes: bf16 and f32.
RESIDENT = {(1, 4): (8, 8), (1, 5): (8, 8), (1, 6): (4, 4), (2, 3): (2, 4)}
# The lane block a bf16 net of 3 or 8 hidden layers takes, with the ring.
RING = {(1, 4): 8, (1, 5): 8, (1, 6): 8, (2, 3): 4}


@pytest.mark.parametrize("use_cfr", [True, False])
@pytest.mark.parametrize("dims", GAMES)
def test_plan_table(dims, use_cfr):
    """(c): every 256x2 net keeps its lane block with its weights
    resident; 256x3 and 256x8 in bf16 fit with the ring; narrower nets take
    the 256x2 net's lane block and layout; f32 never takes the bf16
    ring."""
    game = LiarsDice(*dims)
    params = _params(use_cfr)
    plans = {}
    for dtype, want in zip((torch.bfloat16, torch.float32), RESIDENT[dims]):
        lb = grid2p.choose_lane_block(game, params, _net(game), dtype, 1024)
        plan = grid2p.kernel_plan(game, params, _net(game), dtype, 1024, lb)
        assert (lb, plan.ring) == (want, False)
        plans[dtype] = plan
    for layers in (3, 8):
        deep = _net(game, 256, layers)
        lb = grid2p.choose_lane_block(game, params, deep, torch.bfloat16,
                                      1024)
        plan = grid2p.kernel_plan(game, params, deep, torch.bfloat16, 1024,
                                  lb)
        assert (lb, plan.ring) == (RING[dims], True)
        assert plan.smem <= grid2p.SMEM_LIMIT
        f32 = grid2p.kernel_plan(game, params, deep, torch.float32, 1024,
                                 RESIDENT[dims][1])
        assert not f32.ring
    for width in (1, 32, 100, 128, 129, 200, 256):
        for dtype in (torch.bfloat16, torch.float32):
            net = _net(game, width, 2)
            lb = grid2p.choose_lane_block(game, params, net, dtype, 1024)
            plan = grid2p.kernel_plan(game, params, net, dtype, 1024, lb)
            assert plan == plans[dtype], width


def test_explicit_lane_blocks_take_the_ring_or_raise():
    """2x3f at lane block 4 and 1x6f at 8 take the ring with a 256x2 bf16
    net; 2x3f at 8 does not fit even with it; the f32 MLP has no bf16
    ring."""
    g23, g16 = LiarsDice(2, 3), LiarsDice(1, 6)
    for use_cfr in (True, False):
        assert grid2p.kernel_plan(g23, _params(use_cfr), _net(g23),
                                  torch.bfloat16, 1024, 4).ring
        assert grid2p.kernel_plan(g16, _params(use_cfr), _net(g16),
                                  torch.bfloat16, 1024, 8).ring
        with pytest.raises(ValueError, match="lane_block 8 .* bf16 ring"):
            grid2p.kernel_plan(g23, _params(use_cfr), _net(g23),
                               torch.bfloat16, 1024, 8)
        with pytest.raises(ValueError, match="shared memory"):
            grid2p.kernel_plan(g16, _params(use_cfr), _net(g16),
                               torch.float32, 1024, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_width_over_256_raises_before_any_launch(dtype):
    """A width over 512 (the wide units' padded width; 257-512 run, as
    tests/test_torch_port_wide.py holds) raises before any build or
    launch, naming the limit."""
    game = LiarsDice(1, 4)
    net = _net(game, 513)
    launches = grid2p.solve.launches
    for call in (
            lambda: grid2p.kernel_plan(game, _params(True), net, dtype,
                                       1024, 8),
            lambda: grid2p.choose_lane_block(game, _params(True), net,
                                             dtype, 1024)):
        with pytest.raises(ValueError, match="1-512"):
            call()
    assert grid2p.solve.launches == launches


def test_smem_layout_of_both_layouts():
    """2x3f, lane block 4, CFR, 256x2 bf16: resident, the whole block with
    its barrier (170,064 B) does not fit beside the lanes' state;
    with the ring, the first layer (48 x 256), the head (16 x 256) and the
    f32 parameters stay (38,976 B) and four stages of 32 k rows (16 KB
    each) with their barriers and counts (48 B) stream the hidden
    matrix."""
    game = LiarsDice(2, 3)
    resident = grid2p.smem_layout(game, 4, True, 256, 2, True)
    ring = grid2p.smem_layout(game, 4, True, 256, 2, True, ring=True)
    assert resident["mlp"] == 170064 and resident["ring"] == 0
    assert resident["total"] > grid2p.SMEM_LIMIT
    assert ring["mlp"] == (48 + 16) * 256 * 2 + 4 * (3 * 2 * 256 + 16) + 16
    assert ring["ring"] == 4 * 32 * 256 * 2 + 48
    assert ring["lanes"] == resident["lanes"]
    assert ring["total"] == sum(v for k, v in ring.items() if k != "total")
    assert ring["total"] <= grid2p.SMEM_LIMIT
    # The two-group kernel: a ring for each group.
    two = grid2p.smem_layout(game, 4, True, 256, 2, True, groups=2,
                             ring=True)
    assert two["ring"] == 2 * (4 * 32 * 256 * 2 + 48)
    # Deeper: the same ring; only the f32 parameters (3 x 256 a layer)
    # stay resident with each more layer.  One hidden layer has none to
    # ring.
    deep = grid2p.smem_layout(game, 4, True, 256, 8, True, ring=True)
    assert deep["ring"] == ring["ring"]
    assert deep["mlp"] - ring["mlp"] == 4 * 3 * 6 * 256
    with pytest.raises(ValueError, match="two or more"):
        grid2p.smem_layout(game, 4, True, 256, 1, True, ring=True)


def test_python_constants_are_the_kernels():
    """The wrapper's mirrors of the kernel's constants: the rings' sizes,
    the padded widths (the narrow units' and the wide units', from which
    unit on) and the wide units' rings and rows, and the breakdown's
    switches."""
    from rebel_tpu_torch import mlp_breakdown

    src = KERNEL.read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src)[1])
    for name in ("RING_K", "RING_STAGES", "RING16_K", "RING16_STAGES",
                 "MMA_ROWS", "WARP_ROWS", "REACH_NB", "WIDE_RING_K",
                 "WIDE_RING16_STAGES", "WIDE_WARP_ROWS", "WIDE_UNIT0"):
        assert define(name) == getattr(grid2p, name), name
    assert define("NARROW_NHP") == grid2p.KERNEL_WIDTH == 256
    assert define("WIDE_NHP") == grid2p.WIDE_WIDTH == 512
    assert grid2p.KERNEL_WIDTHS == (256, 512)
    for width in grid2p.KERNEL_WIDTHS:
        wide = width == grid2p.WIDE_WIDTH
        assert grid2p.ring_k(width) == define("WIDE_RING_K" if wide
                                              else "RING_K")
        assert grid2p.ring16_stages(width) == define(
            "WIDE_RING16_STAGES" if wide else "RING16_STAGES")
        assert grid2p.warp_rows(width) == define("WIDE_WARP_ROWS" if wide
                                                 else "WARP_ROWS")
    cuts = dict(re.findall(r"#define CUT_(\w+) (\d+)", src))
    assert {k: int(v) for k, v in cuts.items()} == mlp_breakdown.CUTS


@pytest.mark.parametrize("use_cfr", [True, False])
def test_kernel_unit_is_the_c_interfaces_choice(use_cfr):
    """``grid2p.kernel_unit`` (which unit a breakdown builds) against the C
    interface's choice of unit and each unit's instantiation, read from
    the source: every combination of workspace, operands, ring and
    groups."""
    src = KERNEL.read_text()
    assert ("if (width > NARROW_NHP) return WIDE_UNIT0 + 2 * mma + (p.fp ? 1 "
            ": 0);") in src
    assert ("const int kind = (p.ws_level > 0 ? 3 : 0) + (mma ? (p.ring ? 2 "
            ": 1) : 0);") in src
    assert "const int kernel = p.groups == 2 ? 2 : p.fp ? 1 : 0;" in src
    assert "return 3 * kind + kernel;" in src
    assert "return unit_launches[unit](p, smem, s);" in src
    assert "constexpr int kind = U / 3, kernel = U % 3;" in src
    assert ("return launch<WT, kernel == 1, kernel == 2 ? 2 : 1, kind % 3 == "
            "2,\n                      (kind >= 3)>(p, smem, s);") in src
    assert "constexpr bool mma = (U - WIDE_UNIT0) / 2 == 1;" in src
    assert ("return launch<WT, (U - WIDE_UNIT0) % 2 == 1, 1, mma, false>(p, "
            "smem,") in src
    assert "constexpr int UNITS = 22;" in src
    params = SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=use_cfr,
                                  linear_update=True)
    seen = set()
    for ws, bf16, net, ring, groups in itertools.product(
            (0, 3), (False, True), (False, True), (False, True), (1, 2)):
        if groups == 2 and not (use_cfr and net):
            continue  # the two-group kernel is CFR with a net only
        plan = grid2p.KernelPlan("exact", groups, 1, bf16, 0, ring, ws)
        mma = bf16 and net
        kind = (3 if ws > 0 else 0) + ((2 if ring else 1) if mma else 0)
        kernel = 2 if groups == 2 else 0 if use_cfr else 1
        unit = grid2p.kernel_unit(params, plan, net)
        assert unit == 3 * kind + kernel
        # The unit's instantiation: operands, FP, groups, ring, workspace.
        assert (unit // 3 % 3 != 0, unit % 3 == 1, unit % 3 == 2,
                unit // 3 % 3 == 2, unit // 3 >= 3) == (
            mma, not use_cfr, groups == 2, mma and ring, ws > 0)
        seen.add(unit)
    assert seen == ({u for u in range(18) if u % 3 != 1} if use_cfr
                    else {u for u in range(18) if u % 3 == 1})
    # The wide units: operands and FP, one group of warps, no workspace;
    # bf16 on the ring where the net has hidden matrices (its template's
    # ring flag is the operands').
    wide = set()
    for bf16, net, ring in itertools.product((False, True), (False, True),
                                             (False, True)):
        plan = grid2p.KernelPlan("exact", 1, 1, bf16, 0, ring, 0, 0,
                                 grid2p.WIDE_WIDTH)
        unit = grid2p.kernel_unit(params, plan, net)
        mma = bf16 and net
        assert unit == grid2p.WIDE_UNIT0 + 2 * mma + (not use_cfr)
        assert ((unit - grid2p.WIDE_UNIT0) // 2 == 1,
                (unit - grid2p.WIDE_UNIT0) % 2 == 1) == (mma, not use_cfr)
        wide.add(unit)
    assert wide == {grid2p.WIDE_UNIT0 + 2 * m + (not use_cfr)
                    for m in (0, 1)}
    from rebel_tpu_torch.kernels import build
    assert build.UNITS["grid2_cfr"] == grid2p.WIDE_UNIT0 + 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("width,layers,solver", [(256, 3, "cfr"),
                                                 (100, 5, "cfr"),
                                                 (48, 8, "fp")])
def test_ring_bits_nets_give_the_same_bits(width, layers, solver):
    """(d): ``chip_smoke.ring_bits_nets``' deep net and its 2-layer
    counterpart give the same bits in the plain version with the
    activation ablated (as the kernel must, one on the ring and one
    resident), and a middle layer that maps one column otherwise, as a
    slab of the wrong layer would, gives other bits."""
    game = LiarsDice(1, 4)
    deep, base = _chip_smoke().ring_bits_nets(game, width, layers, 7)
    assert (deep.n_layers, base.n_layers) == (layers, 2)
    assert all(ln is None for _, ln in deep.hidden_layers())
    rng = np.random.RandomState(layers)
    kw = dict(num_iters=16, max_depth=2, use_cfr=solver == "cfr",
              linear_update=True)
    args = (game, SubgameSolvingParams(**kw),
            torch.as_tensor(rng.randint(-1, game.num_actions - 1, size=B)),
            torch.as_tensor(rng.randint(0, 2, size=B)),
            torch.as_tensor(rng.dirichlet(np.ones(game.num_hands),
                                          size=(B, 2)).astype(np.float32)),
            torch.as_tensor(rng.randint(0, kw["num_iters"] + 1, size=B)))
    solve = lambda net: grid2p.solve(*args, net, torch.bfloat16,
                                     ablate="nogelu")
    want = solve(base)
    assert all(torch.equal(x, y) for x, y in zip(solve(deep), want))
    with torch.no_grad():
        w = deep.hidden_layers()[1][0].weight
        w[[0, 1]] = w[[1, 0]]
    assert not all(torch.equal(x, y) for x, y in zip(solve(deep), want))


def test_sum_order_counts_snapshot_lanes(tmp_path):
    """``python3 chip_studies.py sum-order --fresh`` on a small net of the
    ``widths`` phase's kind: each plain version is held to the f32 one
    and to the one with exact sums, and each row counts the share of lanes whose snapshots move by more
    than ``chip_smoke.py``'s LANE_TOL (the lanes statistic of its
    checks); the f32 version against itself would read 0."""
    import json

    spec = importlib.util.spec_from_file_location(
        "chip_studies", ROOT / "chip_studies.py")
    studies = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(studies)
    assert studies.LANE_TOL == _chip_smoke().LANE_TOL
    rows = studies.main(["sum-order", "--out", str(tmp_path), "--game", "1x4",
                         "--fresh", "16x3", "--noln", "--net-seed", "1",
                         "--solver", "fp", "--lanes", "4", "--iters", "4",
                         "--orders", "f32", "f64", "tc_chained"])
    assert [r["pair"] for r in rows] == ["f32-f64", "f32-tc_chained",
                                         "f64-tc_chained"]
    for r in rows:
        assert r["net"] == "16x3 noln" and 0 <= r["snap_lanes"] <= 1
        assert r["rvm_max"] < 1e-3
    assert json.loads((tmp_path / "sum_order.json").read_text()) == rows
