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
the kernel's own figures for the f32 staging; and a layout that does not
fit raises in ``kernel_plan``, which ``solve`` calls before it builds or
launches anything.
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
    B, the barrier 16 B, CTA tables 1,136 B, lane state 4,992 B a lane
    (CFR) and 6,432 B (FP), no activations staged; all fit."""
    shapes = grid2p.mlp_block_shapes(GAME, 256, 2)
    assert sum(2 * n * k for n, k in shapes) == 151552
    qpad = 20  # the f32 kernel's padding of the query size 19 to 4
    assert 2 * (qpad * 256 + 256 * 256 + 256 * 4) == 143360
    assert grid2p.mlp_block_bytes(GAME, 256, 2) == 151552 + 6176
    for use_cfr, per_lane, total in ((True, 4992, 198816),
                                     (False, 6432, 210336)):
        got = grid2p.smem_layout(GAME, 8, use_cfr, 256, 2, True)
        assert got == dict(mlp=151552 + 6176 + 16, tables=1136,
                           lanes=8 * per_lane, staging=0, total=total)
        assert total <= grid2p.SMEM_LIMIT
    # grid2_cfr_il2: the same bytes, the lanes in two groups.
    assert grid2p.smem_layout(GAME, 8, True, 256, 2, True, groups=2) == \
        grid2p.smem_layout(GAME, 8, True, 256, 2, True)


@pytest.mark.parametrize(
    "lane_block,use_cfr,mlp_chunks,bf16,total",
    # The kernel's own figures for the f32 staging at lane block 8 and FP
    # at 16 (its grid2_cfr_smem_bytes on the card, PERF.md).
    [(8, True, 1, False, 517744), (8, True, 2, False, 313456),
     (8, True, 3, False, 245360), (16, False, 7, False, 240240),
     (8, True, 7, False, 109168), (12, True, 1, True, 218784),
     (12, False, 1, True, 236064), (16, True, 1, True, 238752)])
def test_smem_reckoning_matches_the_kernel(lane_block, use_cfr, mlp_chunks,
                                           bf16, total):
    got = grid2p.smem_layout(GAME, lane_block, use_cfr, 256, 2, bf16,
                             mlp_chunks=mlp_chunks)
    assert got["total"] == total
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert (got["staging"] == 0) == bf16


@pytest.mark.parametrize(
    "kw,match",
    [(dict(dtype=torch.bfloat16, n_layers=3), "shared memory"),
     (dict(dtype=torch.bfloat16, use_cfr=False, lane_block=12),
      "shared memory"),
     (dict(dtype=torch.bfloat16, lane_block=16), "shared memory"),
     (dict(dtype=torch.float32, mlp_chunks=3), "more mlp_chunks"),
     (dict(dtype=torch.float16), "float32 or bfloat16"),
     (dict(dtype=torch.bfloat16, n_hidden=128), "width")])
def test_plan_raises_before_any_launch(kw, match):
    """Layouts that do not fit and nets the kernel does not take raise in
    kernel_plan, which needs no card: solve calls it before it builds or
    launches anything, and never shrinks the lane block to make one fit."""
    net = _net(n_hidden=kw.get("n_hidden", 256),
               n_layers=kw.get("n_layers", 2))
    lane_block = kw.get("lane_block", 8)
    with pytest.raises(ValueError, match=match):
        grid2p.kernel_plan(GAME, _params(kw.get("use_cfr", True)), net,
                           kw["dtype"], 48 * lane_block, lane_block,
                           kw.get("mlp_chunks"))


@pytest.mark.parametrize("use_cfr,interleave,groups,smem",
                         [(True, 1, 1, 198816), (False, 1, 1, 210336),
                          (True, 2, 2, 198816), (False, 2, 1, 210336)])
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
    """bf16 stages nothing, so the default is the grouping with the fewest
    turns of the warpgroups over 64-row tiles: at 1x4f one group for every
    lane block.  f32 keeps its default: as many pairs as fill dense()'s
    32-row tile (7 groups at lane block 8)."""
    P = len(grid2p.pseudo_leaf_pairs(GAME))
    assert grid2p.default_mlp_chunks(P, lane_block, 1, True) == 1
    if lane_block % 2 == 0:
        assert grid2p.default_mlp_chunks(P, lane_block, 2, True) == 1
    assert grid2p.default_mlp_chunks(P, lane_block, 1, False) == \
        -(-P // max(1, 32 // lane_block))
    assert grid2p.default_mlp_chunks(P, 8, 1, False) == 7


@pytest.mark.parametrize("n_pairs,lanes,warpgroups",
                         [(28, 8, 2), (28, 4, 1), (10, 13, 2), (66, 3, 1),
                          (6, 22, 2), (36, 5, 2)])
def test_default_mlp_chunks_minimises_turns(n_pairs, lanes, warpgroups):
    """bf16: the default is the smallest number of groups of pairs whose
    64-row tiles take the fewest turns of the warpgroups (a pass's tiles
    are dealt to them in turn)."""
    def turns(chunks):
        per = -(-n_pairs // chunks)
        passes = -(-n_pairs // per)
        return passes * -(-(-(-per * lanes // 64)) // warpgroups)

    groups = 2 // warpgroups
    got = grid2p.default_mlp_chunks(n_pairs, lanes * groups, groups, True)
    best = min(turns(c) for c in range(1, n_pairs + 1))
    assert turns(got) == best
    assert all(turns(c) > best for c in range(1, got))


def test_source_edits_of_the_chip_scripts_apply():
    """The breakdown's variants and ``chip_mutants.py``'s mutants each edit
    one line of the kernel, which must occur exactly once in it (the
    scripts refuse to run otherwise, but only on the card)."""
    import importlib.util
    import pathlib

    from rebel_tpu_torch import mlp_breakdown
    from rebel_tpu_torch.kernels import build

    src = (build.KERNEL_DIR / "grid2_cfr.cu").read_text()
    for name, edit in mlp_breakdown.VARIANTS.items():
        assert edit is None or src.count(edit[0]) == 1, name
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_mutants.py"
    spec = importlib.util.spec_from_file_location("chip_mutants", path)
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    for name in ("mma-b-shift", "mma-head-fragment", "mma-ln-stats"):
        old, new, _ = mutants.MUTANTS[name]
        assert src.count(old) == 1 and old != new, name


def test_breakdown_needs_the_card():
    from rebel_tpu_torch import mlp_breakdown

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    assert mlp_breakdown.main([]) == 1


# The largest lane block of grid2p.LANE_BLOCKS that fits a 256x2 net, by
# game: bf16 CFR, bf16 FP, f32 CFR, f32 FP.
CHOSEN_LANE_BLOCK = {(1, 4): (8, 8, 8, 8), (1, 5): (4, 4, 8, 8),
                     (1, 6): (4, 2, 8, 8), (2, 3): (2, 1, 4, 4)}


@pytest.mark.parametrize("batch", [1024, 2048, 256])
@pytest.mark.parametrize("dice,faces", list(CHOSEN_LANE_BLOCK))
def test_lane_block_is_chosen_from_the_game_and_the_batch(dice, faces,
                                                          batch):
    """Every game of ``eval_all``'s defaults, CFR and FP, bf16 and f32: the
    chosen block is the largest of 8, 4, 2, 1 that fits (always 8 at
    1x4f), the plan at it fits, and the next larger block does not."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    want = iter(CHOSEN_LANE_BLOCK[dice, faces])
    for dtype in (torch.bfloat16, torch.float32):
        for use_cfr in (True, False):
            lb = grid2p.choose_lane_block(game, _params(use_cfr), net, dtype,
                                          batch)
            assert lb == next(want)
            assert grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                      batch, lb).smem <= grid2p.SMEM_LIMIT
            if lb < 8:
                with pytest.raises(ValueError, match="shared memory"):
                    grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                       batch, 2 * lb)


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
    with pytest.raises(ValueError, match="lane_block 1 .* shared memory"):
        grid2p.choose_lane_block(GAME, _params(True), _net(n_layers=3),
                                 torch.bfloat16, 1024)
