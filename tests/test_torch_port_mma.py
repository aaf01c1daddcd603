"""The tensor-core MLP of the port's fused solve, where the CPU reaches it.

With bf16 operands ``kernels/grid2_cfr.cu`` keeps the net in shared
memory, as one block that ``grid2p.pack_mlp_weights`` lays out in the
byte order its tensor-core instructions read; the kernel itself runs on
the card only (``chip_smoke.py``).  Here: the block unpacks to the net's
bf16 weights and f32 parameters exactly, padding included; an MLP that
reads its weights from the block as the kernel does equals the plain
version in bf16 and, in f32 on unrounded weights, the JAX package's net;
the shared-memory reckoning (``smem_layout``, which the wrapper holds
equal to the kernel's on the card) gives the bytes the design states and
the kernel's own figures, bf16 and f32 (the FMA MLP's resident weights,
its warps' rows and its ring); and a layout that does not fit raises in
``kernel_plan``, which ``solve`` calls before it builds or launches
anything.
"""

import jax
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

GAME = LiarsDice(1, 4)


def _net(game=GAME, n_hidden=256, n_layers=2, use_ln=True, seed=0):
    net = CFVNet(game, n_hidden, n_layers, use_ln,
                 generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # LayerNorm parameters other than 1 and 0
        for _, ln in net.hidden_layers():
            if ln is not None:
                ln.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                                   .manual_seed(seed + 1))
                ln.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                                 .manual_seed(seed + 2))
    return net


def unpack(block: torch.Tensor, game: LiarsDice, n_hidden: int,
           n_layers: int) -> dict:
    """The inverse of ``grid2p.pack_mlp_weights``: ``weights`` (bf16
    ``[N, K]`` per layer, padding included), ``bias``, ``ln_scale``,
    ``ln_bias`` (f32 per hidden layer) and ``head_bias`` (f32, padded)."""
    shapes = grid2p.mlp_block_shapes(game, n_hidden, n_layers)
    weights, at = [], 0
    for n, k in shapes:
        raw = block[at:at + 2 * n * k].view(torch.bfloat16)
        weights.append(raw.reshape(n // 8, k // 8, 8, 8).permute(0, 2, 1, 3)
                       .reshape(n, k))
        at += 2 * n * k
    f32 = block[at:].view(torch.float32)
    per = f32[:3 * n_layers * n_hidden].reshape(n_layers, 3, n_hidden)
    return dict(weights=weights, bias=list(per[:, 0]),
                ln_scale=list(per[:, 1]), ln_bias=list(per[:, 2]),
                head_bias=f32[3 * n_layers * n_hidden:])


def _params(use_cfr=True):
    return SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=use_cfr,
                                linear_update=True)


@pytest.mark.parametrize(
    "dice,faces,n_hidden,n_layers,use_ln",
    [(1, 4, 256, 2, True), (1, 4, 256, 1, True), (1, 4, 16, 3, False),
     (1, 6, 24, 2, True), (2, 3, 16, 2, True)])
def test_pack_round_trip(dice, faces, n_hidden, n_layers, use_ln):
    """Unpacking gives back every weight rounded to bf16, zero-padded to
    the shapes the kernel reads, and the f32 biases and LayerNorm
    parameters bit for bit; the block's size is mlp_block_bytes."""
    game = LiarsDice(dice, faces)
    net = _net(game, n_hidden, n_layers, use_ln)
    block = grid2p.pack_mlp_weights(net)
    assert block.dtype == torch.uint8
    assert block.numel() == grid2p.mlp_block_bytes(game, n_hidden, n_layers)
    assert block.numel() % 16 == 0  # the kernel's bulk copies
    got = unpack(block, game, n_hidden, n_layers)
    shapes = grid2p.mlp_block_shapes(game, n_hidden, n_layers)
    layers = [lin for lin, _ in net.hidden_layers()] + [net.output]
    for w, lin, (n, k) in zip(got["weights"], layers, shapes):
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (n, k)
        want = torch.zeros((n, k), dtype=torch.bfloat16)
        rows, cols = lin.weight.shape
        want[:rows, :cols] = lin.weight.detach().to(torch.bfloat16)
        assert torch.equal(w, want)
        assert not w[rows:].any() and not w[:, cols:].any()
    for k, (lin, ln) in enumerate(net.hidden_layers()):
        assert torch.equal(got["bias"][k], lin.bias.detach())
        if ln is None:
            assert not got["ln_scale"][k].any() and not got["ln_bias"][k].any()
        else:
            assert torch.equal(got["ln_scale"][k], ln.weight.detach())
            assert torch.equal(got["ln_bias"][k], ln.bias.detach())
    head = got["head_bias"]
    assert torch.equal(head[:game.num_hands], net.output.bias.detach())
    assert not head[game.num_hands:].any()


def test_pack_layout_is_core_matrices():
    """Byte order of one weight: the 8 x 8 core matrix (n // 8, k // 8),
    row n % 8, column k % 8, with core matrices along K innermost, which is
    what the kernel's wgmma descriptor (the next core matrix along K 128 B
    on, along N 16 K B on) and its mma.sync head assume."""
    net = _net(n_hidden=16, n_layers=1, use_ln=False)
    w = torch.arange(16 * GAME.query_size, dtype=torch.float32).reshape(
        16, GAME.query_size)
    with torch.no_grad():
        net.body[0].weight.copy_(w)
    words = grid2p.pack_mlp_weights(net).view(torch.bfloat16).float()
    k0 = 32  # the query size 19 rounded up to 16
    for n, k in [(0, 0), (3, 5), (9, 18), (15, 17), (7, 8)]:
        at = ((n // 8) * (k0 // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8
        assert float(words[at]) == float(w[n, k].to(torch.bfloat16))
    assert float(words[(0 * 4 + 3) * 64 + 2 * 8 + 7]) == 0.0  # k = 31: pad


@pytest.mark.parametrize("rows", [20, 36, 256])
def test_pack_f32_rows_round_trip(rows):
    """The f32 MLP's weights as the kernel reads them: in every row,
    thread j's two float4 (words 4 j .. 4 j + 3 and 128 + 4 j ..) are its
    columns j + 32 i, i = 0 .. 7 in order; unpacking gives back every
    weight bit for bit."""
    w = torch.randn((rows, 256), generator=torch.Generator().manual_seed(9))
    packed = grid2p.pack_f32_rows(w)
    assert packed.shape == (rows, 2, 32, 4) and packed.is_contiguous()
    flat = packed.reshape(rows, 256)
    for j in (0, 5, 31):
        got = torch.cat([flat[:, 4 * j:4 * j + 4],
                         flat[:, 128 + 4 * j:128 + 4 * j + 4]], dim=1)
        assert torch.equal(got, w[:, j::32])
    assert torch.equal(packed.permute(0, 1, 3, 2).reshape(rows, 256), w)
    with pytest.raises(ValueError, match="256"):
        grid2p.pack_f32_rows(w[:, :128])


def _mlp_from_block(block, game, n_hidden, n_layers, use_ln, act):
    """The net as the kernel reads it from the block: weights [N, K] from
    the core matrices, products in f32 on bf16 operands, then the bias,
    one-pass LayerNorm, the activation, bf16 rounding; the head's first H
    columns."""
    got = unpack(block, game, n_hidden, n_layers)
    k0 = got["weights"][0].shape[1]

    def mlp(x):  # x [Q, N] -> [H, N]
        h = torch.nn.functional.pad(x.T, (0, k0 - x.shape[0]))
        for k in range(n_layers):
            h = (h.to(torch.bfloat16).float() @ got["weights"][k].float().T
                 + got["bias"][k])
            if use_ln:
                mu = h.sum(-1, keepdim=True) / n_hidden
                var = torch.clamp((h * h).sum(-1, keepdim=True) / n_hidden
                                  - mu * mu, min=0.0)
                r = torch.rsqrt(var + 1e-5)
                h = (h * r - mu * r) * got["ln_scale"][k] + got["ln_bias"][k]
            h = act(h)
        out = h.to(torch.bfloat16).float() @ got["weights"][-1].float().T
        return (out + got["head_bias"])[:, :game.num_hands].T

    return mlp


@pytest.mark.parametrize("use_ln", [True, False])
def test_block_computes_the_plain_bf16_mlp(use_ln):
    """What the kernel reads from the block is the plain version's net in
    bf16 (``kernel_mlp``), which the card holds the kernel to."""
    net = _net(n_hidden=32, n_layers=2, use_ln=use_ln, seed=3)
    x = torch.rand((GAME.query_size, 50),
                   generator=torch.Generator().manual_seed(4))
    mlp = _mlp_from_block(grid2p.pack_mlp_weights(net), GAME, 32, 2, use_ln,
                          grid2p.gelu_fast)
    with torch.no_grad():
        want = grid2p.kernel_mlp(net, torch.bfloat16)(x)
    torch.testing.assert_close(mlp(x), want, atol=1e-6, rtol=1e-5)


def test_block_holds_the_jax_net():
    """A JAX net, converted and packed, still holds the JAX package's
    weights: in f32 (bf16 rounding of the operands aside, through the
    unrounded parameters) the block's MLP with the exact GELU equals
    the flax module to 1e-5."""
    jgame = JLiarsDice(1, 4)
    spec = CFVNetSpec(game=jgame, n_hidden=16, n_layers=2,
                      use_layer_norm=True)
    params = jax.tree.map(lambda v: np.asarray(v, np.float32),
                          spec.init_params(jax.random.PRNGKey(5)))
    net = net_from_state_dict(from_flax(params), GAME)
    got = unpack(grid2p.pack_mlp_weights(net), GAME, 16, 2)
    for w, (lin, _) in zip(got["weights"], net.hidden_layers()):
        assert torch.equal(w[:, :lin.in_features],
                           lin.weight.detach().to(torch.bfloat16))
    x = np.random.RandomState(6).rand(7, GAME.query_size).astype(np.float32)
    want = np.asarray(spec.module.apply(params, x))
    h = torch.as_tensor(x)
    for (lin, ln), b, s, lb in zip(net.hidden_layers(), got["bias"],
                                   got["ln_scale"], got["ln_bias"]):
        h = h @ lin.weight.detach().T + b
        h = torch.nn.functional.layer_norm(h, (16,), s, lb, 1e-5)
        h = torch.nn.functional.gelu(h)
    out = h @ net.output.weight.detach().T + got["head_bias"][:4]
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_smem_reckoning_at_the_default_lane_block():
    """1x4f, 256x2 net, lane block 8, bf16: the weights 143,360 B as
    stored before (bf16, first layer padded to 20 rows) and 151,552 B
    padded for the instructions (32 rows, head 8 columns), their f32 parameters 6,176
    B, the barrier 16 B, CTA tables 1,136 B, lane state 4,384 B a lane
    for CFR and FP alike (4,976 B and 6,416 B before the leaf and level-1
    values shared the staging rows and FP dropped its last response, which
    only the optimistic variant reads), no activations staged; all fit."""
    shapes = grid2p.mlp_block_shapes(GAME, 256, 2)
    assert sum(2 * n * k for n, k in shapes) == 151552
    qpad = 20  # the f32 kernel's padding of the query size 19 to 4
    assert 2 * (qpad * 256 + 256 * 256 + 256 * 4) == 143360
    assert grid2p.mlp_block_bytes(GAME, 256, 2) == 151552 + 6176
    for use_cfr, per_lane, total in ((True, 4384, 193952),
                                     (False, 4384, 193952)):
        got = grid2p.smem_layout(GAME, 8, use_cfr, 256, 2, True)
        assert got == dict(mlp=151552 + 6176 + 16, tables=1136,
                           lanes=8 * per_lane, rows=0, ring=0, total=total)
        assert total <= grid2p.SMEM_LIMIT
    # The optimistic FP keeps its last response: 1,440 B a lane more.
    assert grid2p.smem_layout(GAME, 8, False, 256, 2, True,
                              optimistic=True)["lanes"] == 8 * (4384 + 1440)
    # grid2_cfr_il2: the same bytes, the lanes in two groups.
    assert grid2p.smem_layout(GAME, 8, True, 256, 2, True, groups=2) == \
        grid2p.smem_layout(GAME, 8, True, 256, 2, True)


@pytest.mark.parametrize(
    "game,lane_block,use_cfr,bf16,groups,total",
    # The kernel's own figures (its grid2_cfr_smem_bytes, which solve holds
    # equal to smem_layout before every launch on the card): f32 at every
    # game of eval_all's defaults at lane blocks the wrapper has chosen,
    # CFR and FP, at 1x4f with two groups and at lane blocks 16 and 24,
    # and bf16 at lane blocks 12 and 16.
    [((1, 4), 8, True, False, 1, 155040), ((1, 4), 8, False, False, 1, 155040),
     ((1, 4), 8, True, False, 2, 187840), ((1, 4), 16, False, False, 1, 190112),
     ((1, 4), 24, False, False, 1, 225184),
     ((1, 5), 8, True, False, 1, 188720), ((1, 5), 8, False, False, 1, 188720),
     ((1, 6), 4, True, False, 1, 182704), ((1, 6), 4, False, False, 1, 182704),
     ((2, 3), 4, True, False, 1, 219312), ((2, 3), 2, False, False, 1, 180096),
     ((1, 4), 12, True, True, 1, 211488), ((1, 4), 12, False, True, 1, 211488),
     ((1, 4), 16, True, True, 1, 229024)])
def test_smem_reckoning_matches_the_kernel(game, lane_block, use_cfr, bf16,
                                           groups, total):
    got = grid2p.smem_layout(LiarsDice(*game), lane_block, use_cfr, 256, 2,
                             bf16, groups)
    assert got["total"] == total
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert (got["rows"] == 0) == bf16 and (got["ring"] == 0) == bf16


@pytest.mark.parametrize("use_cfr", [True, False])
@pytest.mark.parametrize("dice,faces", [(1, 4), (1, 5), (1, 6), (2, 3)])
def test_f32_layout_by_game(dice, faces, use_cfr):
    """The f32 MLP's shared memory as its design states it, at the lane
    block chosen for a 256x2 net: the first layer (the query rounded up to
    4 rows of 1 KB) resident with its 16-byte barrier; 8 warps x 8 rows of
    1 KB; a ring of 2 stages of 16 KB with their barriers and counts (32
    B), through which the hidden layers stream; the same state a lane as
    with bf16 operands.  One group of pairs is the default (the fewest
    turns of the block's warps), and a third hidden layer adds nothing:
    it streams through the same ring (the head and the f32 parameters are
    read through the L1 cache)."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    lb = grid2p.choose_lane_block(game, _params(use_cfr), net,
                                  torch.float32, 1024)
    got = grid2p.smem_layout(game, lb, use_cfr, 256, 2, False)
    assert got["mlp"] == -(-game.query_size // 4) * 4 * 1024 + 16
    assert got["rows"] == 8 * 8 * 1024
    assert got["ring"] == 2 * 16 * 1024 + 32
    assert got["lanes"] == grid2p.smem_layout(game, lb, use_cfr, 256, 2,
                                              True)["lanes"]
    assert got["total"] <= grid2p.SMEM_LIMIT
    P = len(grid2p.pseudo_leaf_pairs(game))
    assert grid2p.default_mlp_chunks(P, lb, 1, False) == 1
    assert grid2p.smem_layout(game, lb, use_cfr, 256, 3, False) == got


@pytest.mark.parametrize(
    "kw,match",
    [(dict(dtype=torch.bfloat16, n_layers=3, lane_block=32),
      "shared memory"),
     (dict(dtype=torch.bfloat16, use_cfr=False, lane_block=32),
      "shared memory"),
     (dict(dtype=torch.bfloat16, lane_block=32), "shared memory"),
     (dict(dtype=torch.float32, use_cfr=False, lane_block=32),
      "shared memory"),
     (dict(dtype=torch.float16), "float32 or bfloat16"),
     (dict(dtype=torch.bfloat16, n_hidden=513), "256")])
def test_plan_raises_before_any_launch(kw, match):
    """Layouts that do not fit (even with the bf16 ring) and nets the
    kernel does not take (wider than 512; the message names both padded
    widths) raise in kernel_plan, which
    needs no card: solve calls it before it builds or
    launches anything, and never shrinks the lane block to make one fit."""
    net = _net(n_hidden=kw.get("n_hidden", 256),
               n_layers=kw.get("n_layers", 2))
    lane_block = kw.get("lane_block", 8)
    with pytest.raises(ValueError, match=match):
        grid2p.kernel_plan(GAME, _params(kw.get("use_cfr", True)), net,
                           kw["dtype"], 48 * lane_block, lane_block,
                           kw.get("mlp_chunks"))


@pytest.mark.parametrize("use_cfr,interleave,groups,smem",
                         [(True, 1, 1, 193952), (False, 1, 1, 193952),
                          (True, 2, 2, 193952), (False, 2, 1, 193952)])
def test_plan_at_the_main_path(use_cfr, interleave, groups, smem):
    """The main path's launch: lane block 8, bf16, one group of pairs (the
    least row padding), fits; interleave=2 takes the two-group kernel for
    CFR only."""
    plan = grid2p.kernel_plan(GAME, _params(use_cfr), _net(), torch.bfloat16,
                              1024, 8, interleave=interleave)
    assert plan == grid2p.KernelPlan("fast", groups, 1, True, smem)
    nonet = grid2p.kernel_plan(GAME, _params(use_cfr), None, torch.bfloat16,
                               1024, 8)
    assert nonet.smem == grid2p.smem_layout(GAME, 8, use_cfr, 0, 0,
                                            True)["total"]
    assert nonet.smem < 60000  # no weights without a net


@pytest.mark.parametrize("lane_block", [1, 2, 4, 8, 12, 16])
def test_default_mlp_chunks(lane_block):
    """Neither MLP stages a group of pairs, so the default is the grouping
    with the fewest turns over the tiles of query rows (bf16: the
    warpgroups' 64-row tiles; f32: 8 rows for each of the block's warps):
    at 1x4f one group for every lane block."""
    P = len(grid2p.pseudo_leaf_pairs(GAME))
    for mma in (True, False):
        assert grid2p.default_mlp_chunks(P, lane_block, 1, mma) == 1
        if lane_block % 2 == 0:
            assert grid2p.default_mlp_chunks(P, lane_block, 2, mma) == 1


@pytest.mark.parametrize("mma", [True, False])
@pytest.mark.parametrize("n_pairs,lanes,warpgroups",
                         [(28, 8, 2), (28, 4, 1), (10, 13, 2), (66, 3, 1),
                          (6, 22, 2), (36, 5, 2)])
def test_default_mlp_chunks_minimises_turns(n_pairs, lanes, warpgroups, mma):
    """The default is the smallest number of groups of pairs whose tiles
    take the fewest turns (a pass's tiles are dealt in turn): bf16's
    64-row tiles to the group's warpgroups, f32's tiles of 8 rows for
    each of the group's warps (64 rows a block, 32 a group of two) one a
    turn."""
    groups = 2 // warpgroups
    tile, tiles = (64, warpgroups) if mma else (64 // groups, 1)

    def turns(chunks):
        per = -(-n_pairs // chunks)
        passes = -(-n_pairs // per)
        return passes * -(-(-(-per * lanes // tile)) // tiles)

    got = grid2p.default_mlp_chunks(n_pairs, lanes * groups, groups, mma)
    best = min(turns(c) for c in range(1, n_pairs + 1))
    assert turns(got) == best
    assert all(turns(c) > best for c in range(1, got))


def test_source_edits_of_the_chip_scripts_apply():
    """The breakdown's variants take out parts by the kernel's own
    switches (``-DBREAKDOWN=`` a mask of its ``CUT_*`` defines, each used
    in the source), and ``chip_mutants.py``'s mutants each edit one line of
    the kernel, which must occur exactly once in it (the script refuses
    to run otherwise, but only on the card)."""
    import importlib.util
    import pathlib
    import re

    from rebel_tpu_torch import mlp_breakdown
    from rebel_tpu_torch.kernels import build

    src = (build.KERNEL_DIR / "grid2_cfr.cu").read_text()
    cuts = {k: int(v) for k, v in re.findall(r"#define CUT_(\w+) (\d+)",
                                             src)}
    assert cuts == mlp_breakdown.CUTS
    for name in cuts:
        assert f"CUT(CUT_{name})" in src, name
    for variants in (mlp_breakdown.VARIANTS, mlp_breakdown.MLP32_VARIANTS,
                     mlp_breakdown.BODY_VARIANTS,
                     mlp_breakdown.RING16_VARIANTS):
        for name, mask in variants.items():
            assert (mask == 0) == (name == "whole"), name
            assert mask in cuts.values() or mask == 0, name
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_mutants.py"
    spec = importlib.util.spec_from_file_location("chip_mutants", path)
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    for name, (old, new, _) in mutants.MUTANTS.items():
        assert old is None or (src.count(old) == 1 and old != new), name


def test_breakdown_needs_the_card():
    from rebel_tpu_torch import mlp_breakdown

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    assert mlp_breakdown.main([]) == 1


# The largest lane block of grid2p.LANE_BLOCKS that fits a 256x2 net, by
# game: bf16 CFR, bf16 FP, f32 CFR, f32 FP.
CHOSEN_LANE_BLOCK = {(1, 4): (8, 8, 8, 8), (1, 5): (8, 8, 8, 8),
                     (1, 6): (4, 4, 4, 4), (2, 3): (2, 2, 4, 4)}


@pytest.mark.parametrize("batch", [1024, 2048, 256])
@pytest.mark.parametrize("dice,faces", list(CHOSEN_LANE_BLOCK))
def test_lane_block_is_chosen_from_the_game_and_the_batch(dice, faces,
                                                          batch):
    """Every game of ``eval_all``'s defaults, CFR and FP, bf16 and f32: the
    chosen block is the largest of 8, 4, 2, 1 that fits (always 8 at
    1x4f), the plan at it fits with the weights resident, and the next
    larger block does not: in f32 it raises, in bf16 it takes the ring."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    want = iter(CHOSEN_LANE_BLOCK[dice, faces])
    for dtype in (torch.bfloat16, torch.float32):
        for use_cfr in (True, False):
            lb = grid2p.choose_lane_block(game, _params(use_cfr), net, dtype,
                                          batch)
            assert lb == next(want)
            plan = grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                      batch, lb)
            assert plan.smem <= grid2p.SMEM_LIMIT and not plan.ring
            if lb < 8 and dtype == torch.float32:
                with pytest.raises(ValueError, match="shared memory"):
                    grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                       batch, 2 * lb)
            elif lb < 8:
                assert grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                          batch, 2 * lb).ring


def test_lane_block_choice_follows_the_batch_and_interleave():
    """A block must divide the batch, and with interleave=2 be even; an
    explicit block that does not fit still raises, and where no block
    fits the choice raises kernel_plan's error for block 1."""
    net = _net(GAME)
    choose = lambda batch, **kw: grid2p.choose_lane_block(
        GAME, _params(True), net, torch.bfloat16, batch, **kw)
    assert [choose(b) for b in (1056, 12, 6, 3)] == [8, 4, 2, 1]
    assert choose(1056, interleave=2) == 8
    assert choose(6, interleave=2) == 2
    with pytest.raises(ValueError, match="even blocks"):
        choose(3, interleave=2)
    with pytest.raises(ValueError, match="shared memory"):
        grid2p.kernel_plan(LiarsDice(2, 3), _params(False), _net(
            LiarsDice(2, 3)), torch.bfloat16, 1024, 8)
    # The ring keeps the f32 parameters resident (3 KB a layer at width
    # 256), so a deep enough bf16 net fits no block even with the ring.
    with pytest.raises(ValueError, match="lane_block 1 .* shared memory"):
        grid2p.choose_lane_block(GAME, _params(True), _net(n_layers=64),
                                 torch.bfloat16, 1024)
