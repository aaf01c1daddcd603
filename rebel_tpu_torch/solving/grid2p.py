"""The whole depth-2 subgame solve, CFR or fictitious play, as one CUDA
kernel on the card.

Counterpart of ``rebel_tpu/solving/grid2p.py`` (``Grid2PallasSolver``).
Two functions share one contract:

* :func:`solve_reference`: the plain PyTorch version (the batch-last
  solver of :mod:`rebel_tpu_torch.solving.grid2b` plus the stop-iteration
  snapshot scan), on any device;
* :func:`solve`: launches ``kernels/grid2_cfr.cu`` for CUDA tensors (its
  CFR instantiation ``grid2_cfr`` when ``params.use_cfr``, its two-group
  CFR instantiation ``grid2_cfr_il2`` with ``interleave=2``, else its
  fictitious-play instantiation ``grid2_fp``) and takes the plain version
  only for CPU tensors.

Inputs: ``bids/players/t_stop [B]`` ints, ``beliefs [B, 2, H]``, a
:class:`~rebel_tpu_torch.nets.cfv_net.CFVNet` or ``None`` (zero leaf
values).  Outputs: ``rvm [B, 2, H]`` running mean of the root values,
``snap0 [B, H, A]`` and ``snap1 [B, A, H, A]`` the sampling policy (CFR:
the current iterate; FP: the average policy) at each lane's stop
iteration ``t_stop`` (taken before that iteration's update;
``t_stop == num_iters`` takes the final policy).

Both follow the fused kernel's numerics, not grid2b's: with
``net_compute_dtype=torch.bfloat16`` the matmul operands are rounded to
bf16 and accumulate in f32, LayerNorm is one-pass (E[x^2] - mu^2) and all
elementwise math is f32.  Both take the reference kernel's options:

* ``gelu``: ``"auto"`` (the fast polynomial GELU with bf16 operands, the
  Abramowitz-Stegun erf form in f32), ``"exact"`` or ``"fast"``;
* ``ablate``: diagnostics of what the activation and LayerNorm cost:
  ``"nogelu"`` (no activation), ``"noln"`` (layers with LayerNorm skip
  its statistics and keep scale and bias), ``"cheaperf"`` (the fast GELU,
  whatever ``gelu`` says); ``""`` follows ``gelu``;
* ``mlp_chunks``: the P pseudo-leaf pairs are evaluated in that many
  groups of ``ceil(P / mlp_chunks)`` pairs; the kernel runs one group's
  query rows at a time, in row tiles of its product.  Results do not
  depend on it (in the kernel, bit for bit).  ``None`` takes
  :func:`default_mlp_chunks`;
* ``interleave``: 2 splits every lane block into two half-blocks that are
  solved side by side (the kernel: by two groups of warps of one block, so
  that one half's MLP overlaps the other's update).  CFR with a net only;
  FP and the no-net mode run as ``interleave=1``.  Per-lane results equal
  ``interleave=1``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.solving.grid2b import Grid2BatchSolver, RootCtxB
from rebel_tpu_torch.solving.params import SubgameSolvingParams

# The padded hidden widths the kernel runs nets at (its NHP), the layers
# padded with zero columns: nets of width 1-256 at KERNEL_WIDTH, nets of
# 257-512 at WIDE_WIDTH in the wide units of the build (their own
# instantiations; WIDE_UNIT0 on).  Wider nets need another design (ROADMAP
# Queue 6).
KERNEL_WIDTH = 256
WIDE_WIDTH = 512
KERNEL_WIDTHS = (KERNEL_WIDTH, WIDE_WIDTH)
WIDE_UNIT0 = 18
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# The games the kernel takes: hands and actions of a row, which the body
# deals to the lanes of a warp, two values a lane (MAX_ROW), or hands four
# values a lane (MAX_HANDS: the reach rows of the one-group workspace
# instantiations).  Rows wider than NARROW_ROW and bf16 first layers deeper
# than NARROW_K0 run in the kernel's workspace instantiations only.
MAX_ROW = 64
MAX_HANDS = 128
NARROW_ROW = 32
NARROW_K0 = 64
# The tensor-core MLP (bf16 operands): query rows of a warpgroup's tile,
# warpgroups of a block, and the deepest first layer (Q rounded up to 16;
# the f32 MLP takes the same queries).
MMA_ROWS = 64
WARPGROUPS = 2
MAX_K0 = 256
# Levels of the device workspace (the kernel's WS_*): the arrays that move
# out of shared memory, each level with those before it, largest first,
# where no lane block's state fits a block's shared memory otherwise.
WS_PAYOFF = 1  # the payoff table (read where the wrapper keeps it)
WS_LEVEL1 = 2  # the level-1 arrays [A, H, A]
WS_ROWS = 3    # the staging and leaf-value rows
WS_BODY = 4    # the rest of the [H, H], [H, A] and [A, H] arrays
WS_W0 = 5      # f32: the first layer streams through the f32 ring
WS_HEAD = 5    # bf16: the head stays in device memory
# The f32 MLP (FMA): query rows a warp owns, warps of a block, and the
# ring a group of warps streams each hidden matrix through (stages of
# RING_K of its rows).
WARP_ROWS = 8
WARPS = 8
RING_K = 16
RING_STAGES = 2
# The bf16 ring, where a net's hidden matrices do not fit beside the
# lanes' state: stages of RING16_K k rows of a hidden matrix (16 KB at
# width 256), RING16_STAGES of them per group of warps.
RING16_K = 32
RING16_STAGES = 4
# The workspace instantiations' reach phase at rows wider than a warp:
# items a warp takes at a time (one at rows over MAX_ROW hands,
# :func:`reach_nb`); and the words of the state their body phases read
# (the kernel's WsBody), in shared memory where the one-group launches
# call those phases.
REACH_NB = 4
WS_BODY_WORDS = 60
# The wide units' f32 ring stages (RING_K rows: the same 16 KB slabs), bf16
# ring stages (RING16_K rows of 512 columns, 32 KB each) and f32 rows a
# warp, in place of RING_K, RING16_STAGES and WARP_ROWS.
WIDE_RING_K = 8
WIDE_RING16_STAGES = 2
WIDE_WARP_ROWS = 4


def ring_k(width: int) -> int:
    """The f32 ring's k rows a stage at padded width ``width``."""
    return WIDE_RING_K if width > KERNEL_WIDTH else RING_K


def ring16_stages(width: int) -> int:
    """The bf16 ring's stages a group of warps at padded width ``width``."""
    return WIDE_RING16_STAGES if width > KERNEL_WIDTH else RING16_STAGES


def warp_rows(width: int) -> int:
    """The f32 MLP's query rows a warp at padded width ``width``."""
    return WIDE_WARP_ROWS if width > KERNEL_WIDTH else WARP_ROWS


class Grid2Outputs(NamedTuple):
    rvm: torch.Tensor  # [B, 2, H]
    snap0: torch.Tensor  # [B, H, A]
    snap1: torch.Tensor  # [B, A, H, A]


def pseudo_leaf_pairs(game: LiarsDice) -> np.ndarray:
    """``[P, 2]`` level-2 cells (a1, a2), a1 < a2, neither the liar call,
    where the value net is evaluated; P = C(A-1, 2)."""
    A, liar = game.num_actions, game.liar_call
    a1g, a2g = np.meshgrid(np.arange(A), np.arange(A), indexing="ij")
    m = (a2g > a1g) & (a1g != liar) & (a2g != liar)
    return np.stack(np.nonzero(m), axis=1)


def mlp_flops_per_lane_iter(game: LiarsDice, n_hidden: int,
                            n_layers: int) -> int:
    """Model FLOPs of the leaf MLP per lane per solver iteration: the net
    on every pseudo-leaf, 2 FLOP per multiply-add, no padding (the count
    of ``bench.py``; 4.0 MFLOP at 1x4f with a 256x2 net)."""
    per_query = 2 * (game.query_size * n_hidden
                     + (n_layers - 1) * n_hidden * n_hidden
                     + n_hidden * game.num_hands)
    return len(pseudo_leaf_pairs(game)) * per_query


def nonet_ops_per_lane_iter(game: LiarsDice, use_cfr: bool) -> float:
    """Arithmetic operations of one lane-iteration of the fused solve
    outside the MLP (one per add, multiply, divide, compare or max), as
    the algorithm needs them, over the level-0 rows ``L0 = A * H`` and the
    level-1 grid ``L1 = A * A * H``:

    * reach grids: the acting strategy times the belief, times the legal
      mask, ``2 (L0 + L1)``;
    * terminal values of the root's and the ``A`` level-2 liar calls, each
      ``2 H (D + 1)`` to bucket the opponent's mass by match count, ``D``
      suffix sums and ``3 H`` for the mass and ``2 p - mass``;
    * backup: CFR ``4 (L0 + L1)`` (the strategy-weighted or summed child
      values and the regret increments), FP ``2 (L0 + L1)`` (a max or a
      sum over children);
    * update, on the traverser's level only, so half of ``L0 + L1`` an
      iteration on average: CFR 10 a cell (regret add, floor, mask, row
      sum, divide, discount compare and multiply, average-sum multiply,
      reach multiply and add), FP 5 (reach under the best response, sum
      add, linear decay, row sum, divide);
    * the running mean of the root values, ``3 H``.
    """
    A, H, D = game.num_actions, game.num_hands, game.total_num_dice
    cells = A * H + A * A * H
    reach = 2 * cells
    terminal = (1 + A) * (2 * H * (D + 1) + D + 3 * H)
    backup = (4 if use_cfr else 2) * cells
    update = (10 if use_cfr else 5) * cells / 2
    return reach + terminal + backup + update + 3 * H


def split_mul(d: int) -> int:
    """The multiplier with which the fused kernel divides an item index by
    ``d >= 2`` (``split`` in ``grid2_cfr.cu``): ``(i * split_mul(d)) >> 32
    == i // d`` for ``0 <= i`` and ``i * d < 2**32``.  It is
    ``floor((2**32 - 1) / d) + 1``, which exceeds ``2**32 / d`` by less
    than one."""
    if d < 2:
        raise ValueError(f"the work split divides by 2 or more, not {d}")
    return (2**32 - 1) // d + 1


def work_split(game: LiarsDice, lanes: int) -> tuple[int, int, int, int]:
    """The kernel's work split, fixed once per launch for a group of
    ``lanes`` lanes: the multipliers (:func:`split_mul`) that divide an
    item's index by H (a row's hands, and the slots of H threads in a
    warp), by A (the slots of A threads), by ``lanes`` (0 for one lane,
    which needs no division) and by ``lanes`` H (the (row, lane, hand)
    items of the terminal and level-1 phases)."""
    A, H = game.num_actions, game.num_hands
    return (split_mul(H), split_mul(A),
            split_mul(lanes) if lanes > 1 else 0, split_mul(lanes * H))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """GELU with erf from the Abramowitz-Stegun 7.1.26 polynomial
    (|erf err| < 1.5e-7): the kernel's f32-path GELU."""
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    return x * 0.5 * (1.0 + torch.sign(z) * erf_abs)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU with erf(z) ~ clip(z) * poly6(z^2) (|gelu err| < 1.8e-3): the
    kernel's bf16-path GELU."""
    z = torch.clamp(x * 0.7071067811865476, -2.4, 2.4)
    u = z * z
    poly = 1.1283452779263845 + u * (-0.37547712975483916 + u * (
        0.11078739955649257 + u * (-0.024381732600758942 + u * (
            0.0037230956091636926 + u * (-0.00034346830302456875
                                         + u * 1.40787036032954e-05)))))
    return x * (0.5 + 0.5 * (z * poly))


GELUS = ("auto", "exact", "fast")
ABLATIONS = ("", "nogelu", "noln", "cheaperf")
# Activations by the kernel's code for them.
ACTIVATIONS = ("exact", "fast", "identity")


def activation(net_compute_dtype, gelu: str = "auto", ablate: str = "") -> str:
    """The hidden layers' activation, ``"exact"``, ``"fast"`` or
    ``"identity"``, by the reference's precedence: ``nogelu`` first, then
    ``cheaperf``, then ``gelu`` (``"auto"``: fast with bf16 operands)."""
    if gelu not in GELUS:
        raise ValueError(f"gelu must be one of {GELUS}, not {gelu!r}")
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate must be one of {ABLATIONS}, not {ablate!r}")
    if ablate == "nogelu":
        return "identity"
    if ablate == "cheaperf" or gelu == "fast" or (
            gelu == "auto" and net_compute_dtype == torch.bfloat16):
        return "fast"
    return "exact"


def kernel_mlp(net: CFVNet, net_compute_dtype=torch.float32,
               gelu: str = "auto", ablate: str = ""):
    """``x [Q, N] -> [H, N]`` through ``net`` with the kernel's numerics
    (operands in ``net_compute_dtype``, f32 accumulation, one-pass
    LayerNorm, f32 activation picked by :func:`activation`; ``noln`` skips
    the statistics of a layer with LayerNorm and keeps its scale and
    bias)."""
    bf16 = net_compute_dtype == torch.bfloat16
    act = {"exact": gelu_erf, "fast": gelu_fast,
           "identity": lambda x: x}[activation(net_compute_dtype, gelu, ablate)]

    def rnd(t):
        # bf16 operands, products exact in f32, f32 sums.
        return t.to(torch.bfloat16).float() if bf16 else t

    def mlp(x: torch.Tensor) -> torch.Tensor:
        x = x.float().T  # [N, Q]
        for lin, ln in net.hidden_layers():
            x = rnd(x) @ rnd(lin.weight.float()).T + lin.bias.float()
            if ln is not None:
                if ablate != "noln":
                    inv_n = 1.0 / x.shape[-1]
                    mu = x.sum(-1, keepdim=True) * inv_n
                    ex2 = (x * x).sum(-1, keepdim=True) * inv_n
                    var = torch.clamp(ex2 - mu * mu, min=0.0)
                    r = torch.rsqrt(var + 1e-5)
                    x = x * r - mu * r
                x = x * ln.weight.float() + ln.bias.float()
            x = act(x)
        out = net.output
        x = rnd(x) @ rnd(out.weight.float()).T + out.bias.float()
        return x.T

    return mlp


def chunked(mlp, mlp_chunks: int, batch: int):
    """``mlp`` applied to ``x [Q, cells * batch]`` in ``mlp_chunks`` groups
    of whole cells (a cell is one action pair's ``batch`` columns)."""
    if mlp_chunks == 1:
        return mlp

    def run(x: torch.Tensor) -> torch.Tensor:
        cells = x.shape[1] // batch
        per = -(-cells // mlp_chunks)
        return torch.cat([mlp(c) for c in x.split(per * batch, dim=1)], dim=1)

    return run


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_width(n_hidden: int) -> int:
    """The width the kernel runs a net of ``n_hidden`` at:
    :data:`KERNEL_WIDTH` up to 256, :data:`WIDE_WIDTH` for 257-512 (or at
    least the width :func:`_force_width` sets).  Raises ``ValueError``
    above 512."""
    if not 1 <= n_hidden <= WIDE_WIDTH:
        raise ValueError(
            f"the kernel takes hidden widths 1-{WIDE_WIDTH} (padded to "
            f"{KERNEL_WIDTH} or {WIDE_WIDTH}), not {n_hidden}: wider nets "
            f"need another design of its MLP (ROADMAP Queue 6)")
    width = KERNEL_WIDTH if n_hidden <= KERNEL_WIDTH else WIDE_WIDTH
    return max(width, _FORCED_WIDTH or 0)


def _core_matrices(w: torch.Tensor, n_pad: int, k_pad: int) -> torch.Tensor:
    """``w [N, K]`` zero-padded to ``[n_pad, k_pad]`` and cut into 8 x 8
    core matrices ``[n_pad / 8, k_pad / 8, 8, 8]``: the byte order in which
    the kernel's tensor-core instructions read a K-major operand."""
    n, k = w.shape
    w = torch.nn.functional.pad(w, (0, k_pad - k, 0, n_pad - n))
    return w.reshape(n_pad // 8, 8, k_pad // 8, 8).permute(0, 2, 1, 3)


def mlp_block_shapes(game: LiarsDice, n_hidden: int, n_layers: int):
    """``[(N, K), ...]`` of the weights in the bf16 MLP block, hidden layers
    then the head, padded as the kernel reads them at width ``n_hidden``
    (the padded width): K of the first layer is the query size rounded up
    to 16, N of the head the hands rounded up to 8."""
    k0, hn = _ceil(game.query_size, 16), _ceil(game.num_hands, 8)
    return ([(n_hidden, k0 if k == 0 else n_hidden) for k in range(n_layers)]
            + [(hn, n_hidden)])


def mlp_block_bytes(game: LiarsDice, n_hidden: int, n_layers: int) -> int:
    """Bytes of :func:`pack_mlp_weights`'s block at width ``n_hidden``
    (either order): bf16 weights, then f32 bias, LayerNorm scale and bias
    of each hidden layer and the head's bias."""
    shapes = mlp_block_shapes(game, n_hidden, n_layers)
    return (sum(2 * n * k for n, k in shapes)
            + 4 * (3 * n_layers * n_hidden + shapes[-1][0]))


def mlp_resident_bytes(game: LiarsDice, n_hidden: int, n_layers: int,
                       ring: bool) -> int:
    """Bytes of the block that shared memory keeps for a launch: all of
    it, or with the ring the first layer, the head and the f32
    parameters."""
    whole = mlp_block_bytes(game, n_hidden, n_layers)
    return whole - 2 * (n_layers - 1) * n_hidden * n_hidden if ring else whole


def _pad(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x`` zero-padded at the end of each dimension to ``shape``."""
    pads = []
    for have, want in zip(reversed(x.shape), reversed(shape)):
        pads += [0, want - have]
    return torch.nn.functional.pad(x, pads)


@torch.no_grad()
def pack_f32_params(net: CFVNet, width: int) -> torch.Tensor:
    """The f32 parameters of the net at ``width`` (its own or wider):
    each hidden layer's bias, LayerNorm scale and LayerNorm bias (zeros
    without LayerNorm), then the head's bias padded to the hands rounded
    up to 8, every part zero-padded.  Both MLPs read them so."""
    f32 = []
    for lin, ln in net.hidden_layers():
        zero = torch.zeros_like(lin.bias)
        f32 += [_pad(x.float(), width) for x in (
            lin.bias, zero if ln is None else ln.weight,
            zero if ln is None else ln.bias)]
    f32.append(_pad(net.output.bias.float(), _ceil(net.game.num_hands, 8)))
    return torch.cat(f32)


@torch.no_grad()
def pack_mlp_weights(net: CFVNet, width: int | None = None,
                     ring: bool = False) -> torch.Tensor:
    """The net as the kernel's bf16 MLP reads it at ``width`` (default:
    the net's own; the kernel's is :data:`KERNEL_WIDTH`): one ``uint8``
    block on the net's device.  Per hidden layer, then the head: ``weight
    [N, K]`` (the transpose of the product's ``[K, N]``) rounded to bf16,
    zero-padded to :func:`mlp_block_shapes` and cut by
    :func:`_core_matrices`; then :func:`pack_f32_params`.  ``ring``: the
    order the kernel's bf16 ring reads, the part it keeps resident first
    (the first layer, the head, the f32 parameters), then hidden layers 1
    .. NL - 1 as the ring's slabs, :data:`RING16_K` k rows of a layer at a
    time, each slab cut into core matrices ``[N / 8][RING16_K / 8][8][8]``.
    """
    width = width or net.n_hidden
    if width < net.n_hidden:
        raise ValueError(f"width {width} is narrower than the net's "
                         f"{net.n_hidden}")
    shapes = mlp_block_shapes(net.game, width, net.n_layers)
    layers = [lin for lin, _ in net.hidden_layers()] + [net.output]
    mats = [_core_matrices(lin.weight.float(), n, k).to(torch.bfloat16)
            for lin, (n, k) in zip(layers, shapes)]
    f32 = pack_f32_params(net, width)
    if ring:
        # [N / 8, K / 8, 8, 8] -> [K / RING16_K, N / 8, RING16_K / 8, 8, 8]
        slabs = [m.reshape(width // 8, width // RING16_K, RING16_K // 8, 8, 8)
                 .permute(1, 0, 2, 3, 4) for m in mats[1:-1]]
        mats = [mats[0], mats[-1]]
    else:
        slabs = []
    as_bytes = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([as_bytes(m) for m in mats] + [f32.view(torch.uint8)]
                     + [as_bytes(m) for m in slabs])


def mlp32_words(game: LiarsDice, n_hidden: int) -> int:
    """4-byte words the f32 MLP keeps in shared memory for the launch at
    width ``n_hidden``: the first layer ``[Qpad, N]`` (the query size
    rounded up to 4; the hidden layers stream through the ring, and the
    head and the f32 parameters are read through the L1 cache)."""
    return _ceil(game.query_size, 4) * n_hidden


def pack_f32_rows(w: torch.Tensor) -> torch.Tensor:
    """``w [K, N]`` (f32, the product's ``[in, out]``, N a padded width,
    256 or 512) as the kernel's f32 MLP reads it: in each row, column ``j
    + 32 (4 c + e)`` at ``128 c + 4 j + e``, so that thread ``j`` of a
    warp, which owns the columns ``j + 32 i``, reads its N / 32 as float4
    and the warp reads neighbouring words."""
    k, n = w.shape
    if n not in KERNEL_WIDTHS:
        raise ValueError(f"the f32 MLP packs rows of {KERNEL_WIDTH} or "
                         f"{WIDE_WIDTH} columns, not {n}")
    return w.reshape(k, n // 128, 4, 32).permute(0, 1, 3, 2).contiguous()


@torch.no_grad()
def pack_f32_net(net: CFVNet, width: int) -> tuple:
    """The net as the kernel's f32 MLP reads it at ``width`` (its own or
    wider), on the net's device: the first layer ``[Qpad, N]``
    (rows padded to the query size rounded up to 4) and the hidden layers
    1 .. NL - 1 one after another ``[(NL - 1) N, N]`` (None for one hidden
    layer), each in the row order of :func:`pack_f32_rows`; the head
    ``[N, H]`` row-major; :func:`pack_f32_params`.  Every tensor is fresh,
    so 16-byte aligned for the kernel's bulk copies."""
    qpad = _ceil(net.game.query_size, 4)
    mats = [lin.weight.float().T for lin, _ in net.hidden_layers()]
    hidden = None
    if len(mats) > 1:
        hidden = torch.cat([pack_f32_rows(_pad(w, width, width))
                            for w in mats[1:]])
    return (pack_f32_rows(_pad(mats[0], qpad, width)), hidden,
            _pad(net.output.weight.float().T, width,
                 net.game.num_hands).contiguous(),
            pack_f32_params(net, width))


def smem_layout(game: LiarsDice, lane_block: int, use_cfr: bool,
                n_hidden: int, n_layers: int, bf16: bool,
                groups: int = 1, optimistic: bool = False,
                ring: bool = False, workspace: int = 0) -> dict:
    """Bytes of a block's shared memory by part, as the kernel's
    ``make_layout()`` lays it out at the padded width ``n_hidden`` (the
    wrapper holds the two equal on the card): ``mlp`` (with a net: the
    weights kept for the launch and their barrier; bf16 the packed MLP
    block, or with ``ring`` its resident part, f32 :func:`mlp32_words`),
    ``tables`` (pair tables and payoff), ``lanes`` (the solver state of
    all lanes: FP keeps its last best response only when ``optimistic``;
    with a net the leaf values share the staging rows and the level-1
    values the second ones), ``rows`` (f32: each warp's
    :data:`WARP_ROWS` activation rows), ``ring`` (f32 with hidden layers
    to stream: each group's :data:`RING_STAGES` stages of :data:`RING_K`
    weight rows, their barriers and counts; bf16 with ``ring``: each
    group's :data:`RING16_STAGES` stages of :data:`RING16_K` rows, their
    barriers and counts) and ``total``.  ``n_layers`` 0: no net.  At
    :data:`WIDE_WIDTH` (one group of warps, no workspace) the rings and
    the f32 rows take :func:`ring_k`, :func:`ring16_stages` and
    :func:`warp_rows`; the bf16 MLP keeps its f32 parameters out of shared
    memory, and ``tile`` is its 64-row tile's A operand and LayerNorm's
    sums of each half.
    ``mlp_chunks`` does not change it.  ``workspace``: the level (``WS_*``)
    whose arrays live in the device workspace and not in shared memory;
    with one, also ``workspace``, the bytes of a block's part of it (not in
    ``total``; the payoff table of the workspace's levels is the wrapper's
    own tensor, in no part of it; the level-1 arrays keep there only the
    :func:`level1_cells` that can be non-zero), and ``scratch``, each
    warp's rows of :func:`reach_nb` reach items (three rows of ``H``
    values, an odd number of words apart; the f32 MLP's activation rows
    hold them) and, in one group of warps, the :data:`WS_BODY_WORDS` of
    the state the body's phases read, in shared memory.  bf16 at
    :data:`WS_HEAD` keeps the head in device memory (``mlp`` is then the
    first layer, any resident hidden layers and the f32 parameters)."""
    A, H = game.num_actions, game.num_hands
    P = len(pseudo_leaf_pairs(game))
    words = lambda *ns: sum(_ceil(n, 4) for n in ns)
    net = n_layers > 0
    mma = net and bf16
    fma = net and not bf16
    ring16 = mma and ring
    wide = n_hidden > KERNEL_WIDTH
    if ring and not (mma and n_layers > 1):
        raise ValueError("the ring streams the hidden layers of a bf16 net "
                         "of two or more")
    if not 0 <= workspace <= max_workspace(n_layers, bf16, groups):
        raise ValueError(f"no workspace level {workspace} for this net")
    if wide and (groups != 1 or workspace):
        raise ValueError(f"width {n_hidden} runs in one group of warps "
                         "without the workspace")
    w0_ring = fma and workspace >= WS_W0  # the f32 first layer streams
    mlp = 0
    if mma:
        resident = mlp_resident_bytes(game, n_hidden, n_layers, ring)
        hn = _ceil(game.num_hands, 8)
        if workspace >= WS_HEAD:  # the head stays in device memory
            resident -= 2 * hn * n_hidden
        elif wide:  # the f32 parameters stay in device memory
            resident -= 4 * (3 * n_layers * n_hidden + hn)
        mlp = words(resident // 4, 2)
    elif fma:
        mlp = words(0 if w0_ring else mlp32_words(game, n_hidden), 2)
    tables = words(P, P, A * A,
                   0 if workspace >= WS_PAYOFF else A * H * H)
    LB = lane_block // groups
    last = 1 if use_cfr or optimistic else 0
    fp = 0 if use_cfr else 1
    # Each array of the lanes' state with the level from which it lives in
    # the workspace (0: never), in make_layout()'s order.
    cells1 = level1_cells(A) * H if workspace >= WS_LEVEL1 else A * H * A
    # The workspace's launches compute the root bid's win table [H, H]
    # where they need it and keep none.
    mwin = 0 if workspace else LB * H * H
    state = [(0, LB), (0, LB), (0, LB), (0, LB * A), (0, LB * 2 * H),
             (WS_BODY, mwin), (WS_BODY, last * LB * H * A),
             (WS_BODY, LB * H * A), (WS_LEVEL1, last * LB * cells1),
             (WS_LEVEL1, LB * cells1), (0, LB * 2 * H), (0, LB * H),
             (WS_BODY, LB * A * H), (WS_BODY, LB * A * H), (0, LB * H),
             (WS_ROWS, P * LB * H), (WS_ROWS, P * LB * H), (WS_ROWS, P * LB)]
    if not net:  # leaf values and level-1 values in rows of their own
        state += [(WS_ROWS, P * LB * H), (WS_ROWS, LB * A * H)]
    state += [(WS_BODY, fp * LB * H * A), (WS_LEVEL1, fp * LB * cells1)]
    moved = lambda lvl: 0 < lvl <= workspace
    lanes = words(*(n for lvl, n in state if not moved(lvl)))
    ws_words = words(*(n for lvl, n in state if moved(lvl)))
    rows = (words(WARPS // groups * warp_rows(n_hidden) * n_hidden) if fma
            else 0)
    if ring16:  # the stages are the block's, the barriers each group's
        st = ring16_stages(n_hidden)
        stages = words(groups * st * RING16_K * n_hidden // 2)
        ring_words = stages + groups * words(3 * st)
    elif fma and (n_layers > 1 or w0_ring):
        ring_words = groups * words(RING_STAGES * ring_k(n_hidden) * n_hidden,
                                    3 * RING_STAGES)
    else:
        ring_words = 0
    parts = dict(mlp=mlp, tables=tables, lanes=groups * lanes,
                 rows=groups * rows, ring=ring_words)
    if wide and mma:
        parts["tile"] = words(MMA_ROWS * n_hidden // 2, 2 * MMA_ROWS * 2)
    if workspace:  # the f32 MLP's rows hold the rows; one group of warps
        # keeps a WsBody (its launches call the phases; the index-checked
        # build's two-group units do too, and keep one a group: solve's
        # index_checked takes that layout from the C side)
        parts["scratch"] = (0 if fma else groups * words(
            WARPS // groups * 3 * reach_nb(H, groups) * (H | 1))) \
            + (WS_BODY_WORDS if groups == 1 else 0)
    parts["total"] = sum(parts.values())
    if workspace:
        parts["workspace"] = groups * ws_words
    return {k: 4 * v for k, v in parts.items()}


def level1_cells(num_actions: int) -> int:
    """Cells ``(a1, a2)`` of a level-1 array that can hold a non-zero
    value, ``a2 > a1`` (the liar call's row has none): all the device
    workspace keeps of each lane's ``[A, H, A]``, ``H`` values a cell."""
    return num_actions * (num_actions - 1) // 2


def max_workspace(n_layers: int, bf16: bool, groups: int = 1) -> int:
    """The deepest workspace level a launch takes: with a net
    :data:`WS_W0` (f32: its first layer may stream) or, in one group of
    warps, :data:`WS_HEAD` (bf16: its head may stay in device memory), both
    5, else :data:`WS_BODY`."""
    if n_layers > 0 and not (bf16 and groups == 2):
        return WS_W0
    return WS_BODY


def reach_nb(hands: int, groups: int = 1) -> int:
    """Reach items a warp of the workspace instantiations takes at a
    time at rows wider than a warp (the kernel's ``reach_nb``):
    :data:`REACH_NB` / ``groups``, and one at rows over :data:`MAX_ROW`
    hands, whose lanes hold four values each."""
    return 1 if hands > MAX_ROW else REACH_NB // groups


def default_mlp_chunks(n_pairs: int, lane_block: int, groups: int,
                       mma: bool, width: int = KERNEL_WIDTH) -> int:
    """``mlp_chunks`` when the caller gives none.  Neither MLP stages a
    group of pairs (the layout does not depend on it), so only the row
    padding counts: the fewest groups of pairs that take the fewest turns
    over the tiles of query rows.  A turn: the tensor-core MLP's (``mma``,
    bf16 with a net) warpgroups each take a 64-row tile (at
    :data:`WIDE_WIDTH` both take one); the f32 MLP's warps each take
    :func:`warp_rows` rows.  1 at 1x4f for every lane block up to 16, with
    either."""
    lanes = lane_block // groups
    if mma:
        tile = MMA_ROWS
        tiles = 1 if width > KERNEL_WIDTH else WARPGROUPS // groups
    else:
        tile, tiles = warp_rows(width) * WARPS // groups, 1

    def turns(chunks):
        per = -(-n_pairs // chunks)
        return -(-n_pairs // per) * -(-(-(-per * lanes // tile)) // tiles)

    return min(range(1, n_pairs + 1), key=lambda c: (turns(c), c))


def deal_rows(rows: int, warpgroups: int = WARPGROUPS) -> list[list[tuple]]:
    """How the tensor-core MLP deals a chunk's ``rows`` query rows, as
    the kernel's loop over turns does: per turn, ``(warpgroup, warp,
    first row, real rows)`` of every warp with a real row.  A turn is a 64-row tile for each of ``warpgroups``; its
    rows go to the warps in groups of 16, group ``j`` to warp ``w`` of
    warpgroup ``g`` with ``j = w + 4 (g ^ (w & 1))`` (one warpgroup: ``j
    = w``), so that the first groups of a turn reach the four schedulers
    (warp ``w``) in turn.  A warp whose 16 rows are all past the end does
    no epilogue and no head, and a warpgroup without a real row no
    products."""
    turns = []
    for t0 in range(0, rows, warpgroups * MMA_ROWS):
        live = []
        for g in range(warpgroups):
            for w in range(4):
                j = w + 4 * (g ^ (w & 1)) if warpgroups == 2 else w
                first = t0 + 16 * j
                if first < rows:
                    live.append((g, w, first, min(16, rows - first)))
        turns.append(live)
    return turns


def deal_wide(n: int) -> list[tuple[int, int, int]]:
    """How the iteration body deals a row of ``n`` hands or actions (at
    most :data:`MAX_HANDS`; actions at most :data:`MAX_ROW`) to one warp
    where it is wider than 32 (the reach items, the root rows), in the
    order its sums visit the values: ``(value, lane, register)``, lane
    ``l`` holding values ``l + 32 j`` in register ``j`` (``j <
    ceil(n / 32)``), the sum over register 0's 32 values, then over
    register 1's, and so on."""
    if not 1 <= n <= MAX_HANDS:
        raise ValueError(f"a warp takes rows of 1-{MAX_HANDS} values, "
                         f"not {n}")
    return [(v, v % 32, v // 32) for v in range(n)]


def level1_cell(num_actions: int, a1: int, a2: int) -> int:
    """Where the device workspace keeps cell ``(a1, a2)``, ``a2 > a1``, of
    a lane's level-1 array: cells row by row, ``a2`` fastest, each ``H``
    values (the kernel's ``row1``), ``0 .. level1_cells(A) - 1``."""
    if not 0 <= a1 < a2 < num_actions:
        raise ValueError(f"the workspace keeps the cells a2 > a1 only, not "
                         f"({a1}, {a2})")
    return a1 * (num_actions - 1) - a1 * (a1 + 1) // 2 - 1 + a2


def deal_reach(n_items: int, hands: int, groups: int = 1) -> list:
    """How the workspace instantiations' reach phase deals a group's
    ``n_items`` items of ``hands`` hands to its warps (:data:`WARPS` /
    ``groups``) at rows wider than a warp: per warp, its batches of ``nb =
    reach_nb(hands, groups)`` items (``e0 = nb (warp + warps n)``), each
    ``(items, values, sums)``: ``values`` the ``(item, hand, lane,
    register)`` each lane computes (lane ``l`` hands ``l + 32 j``, ``j <
    ceil(hands / 32)``), ``sums`` the ``(lane, item, row, hands)`` of each
    summing lane (lane ``3 b + w`` row ``w`` of the batch's item ``b``,
    over ``hands`` in the order it adds them).  Rows of at most
    :data:`NARROW_ROW` hands take the shared-memory layout's loops; rows
    over :data:`MAX_ROW` hands one group of warps only."""
    top = MAX_HANDS if groups == 1 else MAX_ROW
    if not NARROW_ROW < hands <= top:
        raise ValueError(f"the batches of {groups} group(s) take rows of "
                         f"{NARROW_ROW + 1}-{top} hands, not {hands}")
    warps, nb = WARPS // groups, reach_nb(hands, groups)
    out = []
    for w in range(warps):
        batches = []
        for e0 in range(w * nb, n_items, warps * nb):
            items = [e for e in range(e0, e0 + nb) if e < n_items]
            values = [(e, lane + 32 * j, lane, j) for e in items
                      for j in range(_ceil(hands, 32) // 32)
                      for lane in range(32) if lane + 32 * j < hands]
            sums = [(lane, e0 + lane // 3, lane % 3, list(range(hands)))
                    for lane in range(3 * nb) if e0 + lane // 3 < n_items]
            batches.append((items, values, sums))
        out.append(batches)
    return out


def deal_terminal(num_actions: int, hands: int, lanes: int,
                  threads: int = 32 * WARPS) -> list:
    """How the workspace instantiations take the terminal values, as the
    shared-memory loop does: item ``i`` of ``(A + 1) lanes hands`` (rows
    outermost: the challenge rows ``a1 < A``, then the root bid's row
    ``A``) to thread ``i % threads``; per thread, ``(row, lane, h, opponent
    hands in the order they are summed)`` of each value it computes."""
    out = [[] for _ in range(threads)]
    for i in range((num_actions + 1) * lanes * hands):
        row, r = divmod(i, lanes * hands)
        lane, h = divmod(r, hands)
        out[i % threads].append((row, lane, h, list(range(hands))))
    return out


def effective_interleave(params: SubgameSolvingParams, has_net: bool,
                         interleave: int, lane_block: int | None) -> int:
    """1 or 2: ``interleave`` where it applies (CFR with a net), else 1.
    Raises for ``interleave`` other than 1 or 2 and, where 2 applies, for
    an odd ``lane_block``."""
    if interleave not in (1, 2):
        raise ValueError(f"interleave must be 1 or 2, not {interleave}")
    if interleave == 1 or not (params.use_cfr and has_net):
        return 1
    if lane_block is not None and lane_block % 2:
        raise ValueError(f"interleave=2 splits the lane block in two; "
                         f"lane_block {lane_block} is odd")
    return 2


def _check_inputs(game, params, bids, players, beliefs, t_stop):
    if params.max_depth != 2:
        raise ValueError("the fused solve is for depth-2 subgames")
    B = bids.shape[0]
    H = game.num_hands
    if tuple(beliefs.shape) != (B, 2, H):
        raise ValueError(f"beliefs must be [B, 2, H] = {(B, 2, H)}, "
                         f"not {tuple(beliefs.shape)}")
    for name, t in (("players", players), ("t_stop", t_stop)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [B] = ({B},)")


@torch.no_grad()
def solve_loop(game: LiarsDice, params: SubgameSolvingParams,
               bids: torch.Tensor, players: torch.Tensor,
               beliefs: torch.Tensor, t_stop: torch.Tensor, mlp=None,
               dtype: torch.dtype = torch.float32) -> Grid2Outputs:
    """The batch-last solver run for ``num_iters`` iterations in
    ``dtype``, with the sampling policy of every lane taken at its stop
    iteration.  ``mlp`` is the value net as ``x [Q, N] -> [H, N]``
    (``None``: zero leaf values)."""
    _check_inputs(game, params, bids, players, beliefs, t_stop)
    solver = Grid2BatchSolver(game=game, params=params, dtype=dtype, mlp=mlp,
                              device=beliefs.device)
    root = RootCtxB.of(game, bids.long(), players.long())
    state = solver.init(root, beliefs.to(dtype).permute(1, 2, 0))
    s0, s1 = solver.sampling_strategy(state, root)
    t = t_stop.long()
    for it in range(params.num_iters):
        take = t == it
        c0, c1 = solver.sampling_strategy(state, root)
        s0 = torch.where(take, c0, s0)
        s1 = torch.where(take, c1, s1)
        state = solver.step(state, it % 2, root)
    f0, f1 = solver.sampling_strategy(state, root)
    s0 = torch.where(t == params.num_iters, f0, s0)
    s1 = torch.where(t == params.num_iters, f1, s1)
    return Grid2Outputs(
        rvm=state.root_values_means.permute(2, 0, 1).contiguous(),
        snap0=s0.permute(2, 0, 1).contiguous(),
        snap1=s1.permute(3, 0, 1, 2).contiguous(),
    )


def _check_knobs(params, net, net_compute_dtype, lane_block, mlp_chunks,
                 interleave, gelu, ablate):
    """Validate the options; returns ``(activation, groups)``."""
    act = activation(net_compute_dtype, gelu, ablate)
    if mlp_chunks is not None and mlp_chunks < 1:
        raise ValueError(f"mlp_chunks must be at least 1, not {mlp_chunks}")
    return act, effective_interleave(params, net is not None, interleave,
                                     lane_block)


def solve_reference(game: LiarsDice, params: SubgameSolvingParams,
                    bids: torch.Tensor, players: torch.Tensor,
                    beliefs: torch.Tensor, t_stop: torch.Tensor,
                    net: CFVNet | None = None,
                    net_compute_dtype: torch.dtype = torch.float32,
                    lane_block: int | None = None,
                    mlp_chunks: int | None = None, interleave: int = 1,
                    gelu: str = "auto", ablate: str = "") -> Grid2Outputs:
    """Plain PyTorch version of the fused solve (see module doc).  With
    ``interleave=2`` the first and the second halves of all lane blocks
    (of the whole batch without ``lane_block``) are solved apart."""
    B = bids.shape[0]
    lane_block = lane_block or B
    _, groups = _check_knobs(params, net, net_compute_dtype, lane_block,
                             mlp_chunks, interleave, gelu, ablate)
    mlp = None
    if net is not None:
        mlp = kernel_mlp(net, net_compute_dtype, gelu, ablate)
    if groups == 1:
        if mlp is not None:
            mlp = chunked(mlp, mlp_chunks or 1, B)
        return solve_loop(game, params, bids, players, beliefs, t_stop, mlp)
    if B % lane_block:
        raise ValueError(f"batch {B} is not a multiple of lane_block "
                         f"{lane_block}")
    halves = torch.arange(B, device=bids.device).view(-1, 2, lane_block // 2)
    mlp = chunked(mlp, mlp_chunks or 1, B // 2)
    out = None
    for g in range(2):
        idx = halves[:, g].reshape(-1)
        part = solve_loop(game, params, bids[idx], players[idx],
                          beliefs[idx], t_stop[idx], mlp)
        if out is None:
            out = Grid2Outputs(*(x.new_empty((B, *x.shape[1:]))
                                 for x in part))
        for whole, half in zip(out, part):
            whole[idx] = half
    return out


class KernelPlan(NamedTuple):
    act: str  # the hidden layers' activation, one of ACTIVATIONS
    groups: int  # groups of warps: 2 runs grid2_cfr_il2
    mlp_chunks: int
    bf16: bool  # bf16 operands (with a net: the tensor-core MLP)
    smem: int  # bytes of shared memory a block takes
    ring: bool = False  # bf16: the hidden layers stream through the ring
    workspace: int = 0  # the workspace's level (WS_*), 0: none
    ws_bytes: int = 0  # bytes of a block's part of the workspace
    width: int = KERNEL_WIDTH  # the padded width: a wide unit at 512

    @property
    def layout(self) -> str:
        """``resident`` or ``ring`` (the bf16 hidden layers), with
        ``+workspace<level>`` where arrays live in the device workspace and
        ``@512`` at :data:`WIDE_WIDTH`."""
        name = "ring" if self.ring else "resident"
        return name + (f"+workspace{self.workspace}" if self.workspace
                       else "") + (f"@{self.width}"
                                   if self.width != KERNEL_WIDTH else "")


def kernel_plan(game: LiarsDice, params: SubgameSolvingParams,
                net: CFVNet | None, net_compute_dtype: torch.dtype,
                batch: int, lane_block: int, mlp_chunks: int | None = None,
                interleave: int = 1, gelu: str = "auto",
                ablate: str = "") -> KernelPlan:
    """What :func:`solve` launches for these options, worked out before
    anything is built or launched.  A bf16 net keeps its weights resident
    where that layout fits a block's shared memory, and else streams its
    hidden layers through the ring where that fits.  A game whose state
    fits no lane block's shared memory so (:func:`needs_workspace`) moves
    arrays to the device workspace, level by level, resident weights
    before the ring at each level, until the rest fits.  Raises
    ``ValueError`` on an option, a game or a net the kernel does not take
    (over :data:`MAX_HANDS` hands or :data:`MAX_ROW` actions, queries over
    :data:`MAX_K0` values, ``interleave=2`` at over :data:`MAX_ROW` hands,
    a width over 512) and on a layout that does not fit even so
    (never shrinks the lane block, never falls back).  A net of width
    257-512 runs at :data:`WIDE_WIDTH`, its bf16 hidden layers on the ring,
    without the workspace and in one group of warps: a width over 512, such
    a net on a game that needs the workspace, and ``interleave=2`` with it
    raise (ROADMAP Queue 6)."""
    return _plan(game, params, net, net_compute_dtype, batch, lane_block,
                 mlp_chunks, interleave, gelu, ablate,
                 _layouts(game, params, net, net_compute_dtype, interleave))


# Set by _force_workspace: launches take the workspace at this level (or
# the deepest the launch takes), whatever fits.  For the checks that hold
# the workspace to the shared-memory layout bit for bit.
_FORCED_WORKSPACE: int | None = None
# Set by _force_width: every net runs at least at this padded width.  For
# the checks that hold the wide units to the others on narrower nets.
_FORCED_WIDTH: int | None = None


@contextlib.contextmanager
def _force_workspace(level: int):
    """``with grid2p._force_workspace(level):`` every plan in the block
    puts the arrays of ``level`` (at least 1, at most the launch's
    deepest) in the device workspace, resident weights where they fit,
    else the ring."""
    global _FORCED_WORKSPACE
    before, _FORCED_WORKSPACE = _FORCED_WORKSPACE, level
    try:
        yield
    finally:
        _FORCED_WORKSPACE = before


@contextlib.contextmanager
def _force_width(width: int):
    """``with grid2p._force_width(WIDE_WIDTH):`` every plan in the block
    runs its net at that padded width (zero columns past the net's own),
    on the units of that width."""
    global _FORCED_WIDTH
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"no padded width {width}; the kernel's are "
                         f"{KERNEL_WIDTHS}")
    before, _FORCED_WIDTH = _FORCED_WIDTH, width
    try:
        yield
    finally:
        _FORCED_WIDTH = before


def _n_layers(net) -> int:
    return 0 if net is None else net.n_layers


def _width(net) -> int:
    """The padded width a launch with ``net`` runs at."""
    return KERNEL_WIDTH if net is None else padded_width(net.n_hidden)


def _check_wide(game, params, net, net_compute_dtype, interleave) -> None:
    """Raises where a net runs at :data:`WIDE_WIDTH` with what the wide
    units do not take: ``interleave=2`` (two groups of warps, where the
    wide MLP splits a tile's columns over the warpgroups of one), a forced
    workspace, a game whose rows or bf16 first layer only the workspace
    holds (:func:`_wide`), or one whose state fits no lane block without
    the workspace (ROADMAP Queue 6)."""
    bf16 = net_compute_dtype == torch.bfloat16
    width = _width(net)
    if effective_interleave(params, True, interleave, None) == 2:
        raise ValueError(
            f"interleave=2 runs nets of width up to {KERNEL_WIDTH}; at "
            f"width {width} both warpgroups of a block take one tile "
            f"(ROADMAP Queue 6)")
    if _FORCED_WORKSPACE is not None or _wide(game, net, bf16):
        raise ValueError(
            f"nets wider than {KERNEL_WIDTH} run without the device "
            f"workspace, which a game of {game.num_hands} hands and "
            f"{game.num_actions} actions needs (ROADMAP Queue 6)")
    ring = bf16 and net.n_layers > 1
    if smem_layout(game, 1, params.use_cfr, width, net.n_layers, bf16,
                   optimistic=params.optimistic,
                   ring=ring)["total"] > SMEM_LIMIT:
        raise ValueError(
            f"a net of width {net.n_hidden} at {game.num_dice}x"
            f"{game.num_faces} fits no lane block without the device "
            f"workspace, which nets wider than {KERNEL_WIDTH} do not take "
            f"(ROADMAP Queue 6)")


def _wide(game: LiarsDice, net, bf16: bool) -> bool:
    """Rows wider than :data:`NARROW_ROW`, or a bf16 first layer deeper
    than :data:`NARROW_K0`: what only the workspace instantiations hold."""
    return (max(game.num_hands, game.num_actions) > NARROW_ROW
            or (bf16 and net is not None
                and _ceil(game.query_size, 16) > NARROW_K0))


def needs_workspace(game: LiarsDice, params: SubgameSolvingParams,
                    net: CFVNet | None, net_compute_dtype: torch.dtype,
                    interleave: int = 1) -> bool:
    """Whether the launches of this game take the device workspace: its
    rows are wider than a warp or its bf16 first layer deeper than 4 k
    steps (only the workspace instantiations hold those; no such game's
    state fits shared memory anyway), or the smallest lane block (1, or 2
    where ``interleave=2`` applies) fits a block's shared memory neither
    with the weights resident nor on the bf16 ring."""
    groups = effective_interleave(params, net is not None, interleave, None)
    bf16 = net_compute_dtype == torch.bfloat16
    n_layers = _n_layers(net)
    if _width(net) > KERNEL_WIDTH:
        _check_wide(game, params, net, net_compute_dtype, interleave)
        return False
    if _wide(game, net, bf16):
        return True
    rings = (False, True) if bf16 and n_layers > 1 else (False,)
    return all(smem_layout(game, groups, params.use_cfr, KERNEL_WIDTH,
                           n_layers, bf16, groups, params.optimistic,
                           ring)["total"] > SMEM_LIMIT for ring in rings)


def _layouts(game, params, net, net_compute_dtype, interleave):
    """The layouts a launch may take, ``(ring, workspace level)`` in the
    order they are tried: resident, ring, then (where the game needs it)
    each level of the workspace with resident weights, then the ring; with
    a forced workspace only that level; at :data:`WIDE_WIDTH` the one
    layout of the wide units (:func:`_check_wide`)."""
    bf16 = net_compute_dtype == torch.bfloat16
    n_layers = _n_layers(net)
    if _width(net) > KERNEL_WIDTH:
        _check_wide(game, params, net, net_compute_dtype, interleave)
        return [(bf16 and n_layers > 1, 0)]
    groups = effective_interleave(params, net is not None, interleave, None)
    rings = (False, True) if bf16 and n_layers > 1 else (False,)
    if _FORCED_WORKSPACE is not None:
        deepest = max_workspace(n_layers, bf16, groups)
        level = max(1, min(_FORCED_WORKSPACE, deepest))
        return [(ring, level) for ring in rings]
    out = [] if _wide(game, net, bf16) else [(ring, 0) for ring in rings]
    if needs_workspace(game, params, net, net_compute_dtype, interleave):
        out += [(ring, level)
                for level in range(1, max_workspace(n_layers, bf16, groups)
                                   + 1)
                for ring in rings]
    return out


def _plan(game, params, net, net_compute_dtype, batch, lane_block,
          mlp_chunks, interleave, gelu, ablate, layouts) -> KernelPlan:
    """The plan at the first of ``layouts`` that fits this lane block."""
    act, groups = _check_knobs(params, net, net_compute_dtype, lane_block,
                               mlp_chunks, interleave, gelu, ablate)
    if net_compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("net_compute_dtype must be float32 or bfloat16")
    if batch % lane_block:
        raise ValueError(f"batch {batch} is not a multiple of lane_block "
                         f"{lane_block}")
    H, A = game.num_hands, game.num_actions
    if H > MAX_HANDS:
        raise ValueError(
            f"the kernel deals a row's hands to the lanes of a warp, at "
            f"most four a lane: it takes at most {MAX_HANDS} hands, not {H} "
            f"(ROADMAP Queue 6 item 1)")
    if A > MAX_ROW:
        raise ValueError(
            f"the kernel deals a row's actions to the lanes of a warp, two "
            f"a lane: it takes at most {MAX_ROW} actions, not {A} (ROADMAP "
            f"Queue 6 item 1)")
    if _ceil(game.query_size, 16) > MAX_K0:
        raise ValueError(
            f"the kernel's MLP takes queries of up to {MAX_K0} values, not "
            f"{game.query_size} (ROADMAP Queue 6 item 1)")
    if H > MAX_ROW and groups == 2:
        raise ValueError(
            f"interleave=2 takes games of at most {MAX_ROW} hands, not {H}: "
            f"rows over {MAX_ROW} hands run in one group of warps (ROADMAP "
            f"Queue 6 item 8)")
    bf16 = net_compute_dtype == torch.bfloat16
    n_layers = 0
    width = _width(net)
    if net is not None:
        n_layers = net.n_layers
        if n_layers < 1:
            raise ValueError("the kernel takes nets of one hidden layer "
                             "or more")
    mma = bf16 and net is not None
    if mlp_chunks is None:
        mlp_chunks = default_mlp_chunks(len(pseudo_leaf_pairs(game)),
                                        lane_block, groups, mma, width)
    for ring, level in layouts:
        got = smem_layout(game, lane_block, params.use_cfr, width,
                          n_layers, bf16, groups, params.optimistic, ring,
                          level)
        if got["total"] <= SMEM_LIMIT:
            return KernelPlan(act, groups, mlp_chunks, bf16, got["total"],
                              ring, level, got.get("workspace", 0), width)
    how = " with the bf16 ring" if ring else ""
    if level:
        how += f" and the workspace's level {level}"
    raise ValueError(
        f"lane_block {lane_block} needs {got['total']} B of shared memory "
        f"per block{how}, more than {SMEM_LIMIT}; use a smaller lane_block")


# Lane blocks choose_lane_block tries, largest first.  Blocks above 8 fit
# some 1x4f layouts but are a question of speed, not of fit.
LANE_BLOCKS = (8, 4, 2, 1)


def choose_lane_block(game: LiarsDice, params: SubgameSolvingParams,
                      net: CFVNet | None, net_compute_dtype: torch.dtype,
                      batch: int, interleave: int = 1, gelu: str = "auto",
                      ablate: str = "", mlp_chunks: int | None = None) -> int:
    """The largest of :data:`LANE_BLOCKS` that divides ``batch`` and whose
    layout fits a block's shared memory with the weights resident; only
    where no block fits so, the largest that fits with the bf16 ring.
    Where none fits either (:func:`needs_workspace`), the device
    workspace's shallowest level at which a block fits (resident weights
    before the ring), and there the smallest block: its blocks in flight
    keep the least of the workspace in the L2 cache, and the measured
    launches there read as fast or faster than at larger blocks (PERF.md).
    With ``interleave=2`` where it applies, only even blocks.  A pure
    function of the game, the net and the batch, chosen before anything
    is built or launched; raises ``kernel_plan``'s ``ValueError`` for the
    smallest candidate when none fits."""
    groups = effective_interleave(params, net is not None, interleave, None)
    blocks = [lb for lb in LANE_BLOCKS
              if batch % lb == 0 and lb % groups == 0]
    if not blocks:
        raise ValueError(f"no lane block of {LANE_BLOCKS} divides batch "
                         f"{batch}" + (" into even blocks" if groups == 2
                                       else ""))
    if needs_workspace(game, params, net, net_compute_dtype, interleave):
        blocks = blocks[::-1]
    layouts = _layouts(game, params, net, net_compute_dtype, interleave)
    for n, layout in enumerate(layouts):
        for lb in blocks:
            try:
                _plan(game, params, net, net_compute_dtype, batch, lb,
                      mlp_chunks, interleave, gelu, ablate, [layout])
                return lb
            except ValueError:
                if n == len(layouts) - 1 and lb == min(blocks):
                    raise  # not even the smallest fits


@torch.no_grad()
def solve(game: LiarsDice, params: SubgameSolvingParams,
          bids: torch.Tensor, players: torch.Tensor, beliefs: torch.Tensor,
          t_stop: torch.Tensor, net: CFVNet | None = None,
          net_compute_dtype: torch.dtype = torch.float32,
          lane_block: int | None = None, mlp_chunks: int | None = None,
          interleave: int = 1, gelu: str = "auto",
          ablate: str = "", *, index_checked: bool = False) -> Grid2Outputs:
    """The fused solve: one launch of ``kernels/grid2_cfr.cu`` runs all
    ``num_iters`` iterations for CUDA inputs (``B % lane_block == 0``);
    CPU inputs take :func:`solve_reference`.  Adds one per kernel launch
    to ``solve.launches``, to ``solve.launches_by_kernel`` under
    :func:`kernel_name` and to ``solve.launches_by_width`` under the
    padded width (:attr:`KernelPlan.width`); while ``solve.events`` is a
    list, appends a pair of CUDA events around each launch; keeps the
    launch's lane block in ``solve.last_lane_block`` and its layout
    (:attr:`KernelPlan.layout`) in ``solve.last_layout``.  With bf16
    operands and a net the kernel runs the MLP on the tensor cores from
    the block that :func:`pack_mlp_weights` lays out.  Where the plan takes the device
    workspace, the launch allocates it (:attr:`KernelPlan.ws_bytes` a
    block).  Options whose layout does not fit a block's shared memory
    raise (:func:`kernel_plan`) before anything is built or launched; a
    launch the card refuses raises.  ``index_checked``: the launch runs the
    index-checked build of the workspace instantiations
    (``kernels/build.py`` ``load_checked``, ``chip_studies.py bounds``),
    which traps on an index outside its part; its two-group units keep a
    WsBody a group in shared memory, so the launch takes its shared memory
    from the C side and raises ``ValueError`` where that does not fit."""
    dev = beliefs.device
    if dev.type == "cpu":
        return solve_reference(game, params, bids, players, beliefs, t_stop,
                               net, net_compute_dtype, lane_block,
                               mlp_chunks, interleave, gelu, ablate)
    if dev.type != "cuda":
        raise ValueError(f"solve runs on cuda or cpu tensors, not {dev}")
    _check_inputs(game, params, bids, players, beliefs, t_stop)
    B = bids.shape[0]
    if lane_block is None:
        lane_block = choose_lane_block(game, params, net, net_compute_dtype,
                                       B, interleave, gelu, ablate,
                                       mlp_chunks)
    plan = kernel_plan(game, params, net, net_compute_dtype, B, lane_block,
                       mlp_chunks, interleave, gelu, ablate)
    A, H, F = game.num_actions, game.num_hands, game.num_faces
    Q = game.query_size
    Qpad = (Q + 3) // 4 * 4
    mma = plan.bf16 and net is not None  # the tensor-core MLP

    f32 = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()
    i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()
    payoff = np.concatenate(
        [game.terminal_payoff, np.zeros((1, H, H))], axis=0
    )
    keep = [
        f32(torch.as_tensor(game.matches_table)),
        f32(torch.as_tensor(payoff)),
        f32(beliefs), i32(bids), i32(players), i32(t_stop),
    ]
    rvm = torch.empty((B, 2, H), dtype=torch.float32, device=dev)
    snap0 = torch.empty((B, H, A), dtype=torch.float32, device=dev)
    snap1 = torch.empty((B, A, H, A), dtype=torch.float32, device=dev)
    keep += [rvm, snap0, snap1]

    n_hidden = n_layers = ln = 0
    width = plan.width
    weights = [None] * 4  # bf16: the packed block; f32: pack_f32_net's
    if net is not None:
        n_hidden, n_layers = net.n_hidden, net.n_layers
        ln = int(net.hidden_layers()[0][1] is not None)
        if mma:  # the packed block holds the weights and f32 parameters
            weights[0] = pack_mlp_weights(net, width, plan.ring).to(dev)
        else:
            weights = [None if x is None else f32(x)
                       for x in pack_f32_net(net, width)]
            if plan.workspace >= WS_W0:
                # The ring's slabs: the first layer's rows padded with
                # zeros to whole slabs, then the hidden layers.
                first = _pad(weights[0].reshape(Qpad, width),
                             _ceil(Qpad, ring_k(width)), width)
                weights[1] = torch.cat(
                    [first] + ([] if weights[1] is None else
                               [weights[1].reshape(-1, width)])).contiguous()
    # The device workspace: each block's part (uninitialised: the kernel
    # writes every array before it reads it).
    ws = None
    if plan.ws_bytes:
        ws = torch.empty(B // lane_block * plan.ws_bytes // 4,
                         dtype=torch.float32, device=dev)
    keep += weights + [ws]

    ints = [B, lane_block, A, H, F, game.total_num_dice, Q, Qpad, n_hidden,
            n_layers, params.num_iters, int(params.linear_update),
            int(params.dcfr), int(net is not None), int(plan.bf16),
            int(not params.use_cfr), int(params.optimistic),
            ACTIVATIONS.index(plan.act), int(ablate != "noln"),
            plan.mlp_chunks, plan.groups]
    # The multipliers are unsigned 32-bit: passed as the ints of their bits.
    ints += [m - 2**32 if m >= 2**31 else m
             for m in work_split(game, lane_block // plan.groups)]
    ints += [width, ln, int(plan.ring), plan.workspace]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    from rebel_tpu_torch.kernels import build

    lib = (build.load_checked("grid2_cfr") if index_checked
           else build.load("grid2_cfr"))
    _declare(lib)
    smem = lib.grid2_cfr_smem_bytes(c_ints)
    ws_bytes = lib.grid2_cfr_workspace_bytes(c_ints)
    if index_checked and smem > SMEM_LIMIT:
        raise ValueError(f"the index-checked build needs {smem} B of shared "
                         f"memory per block, more than {SMEM_LIMIT}")
    if (ws_bytes != plan.ws_bytes
            or (smem != plan.smem and not index_checked)):
        raise RuntimeError(
            f"the kernel lays out {smem} B of shared memory and {ws_bytes} B "
            f"of workspace a block, and smem_layout reckons {plan.smem} B "
            f"and {plan.ws_bytes} B: the two have come apart")
    ptrs = (ctypes.c_void_p * len(keep))(
        *[0 if t is None else t.data_ptr() for t in keep]
    )
    floats = (ctypes.c_float * 3)(params.dcfr_alpha, params.dcfr_beta,
                                  1.0 / n_hidden if n_hidden else 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = kernel_name(params, net is not None, plan.groups)
    events = None
    if solve.events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    err = lib.grid2_cfr_launch(ptrs, c_ints, floats, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + lib.grid2_cfr_error_string(err).decode()
        )
    if events is not None:
        events[1].record()
        solve.events.append((name, *events))
    solve.launches += 1
    solve.launches_by_kernel[name] += 1
    solve.launches_by_width[width] += 1
    solve.last_lane_block = lane_block
    solve.last_layout = plan.layout
    return Grid2Outputs(rvm=rvm, snap0=snap0, snap1=snap1)


def kernel_name(params: SubgameSolvingParams, has_net: bool = True,
                interleave: int = 1) -> str:
    """The instantiation of the fused kernel that solves ``params``:
    ``interleave=2`` has one of its own for CFR with a net and runs as
    ``interleave=1`` otherwise."""
    if not params.use_cfr:
        return "grid2_fp"
    return "grid2_cfr_il2" if has_net and interleave == 2 else "grid2_cfr"


KERNEL_NAMES = ("grid2_cfr", "grid2_fp", "grid2_cfr_il2")


def kernel_unit(params: SubgameSolvingParams, plan: KernelPlan,
                has_net: bool) -> int:
    """The unit of ``kernels/grid2_cfr.cu`` (``-DGRID2_UNIT``) that holds
    the instantiation a launch of ``plan`` runs, as the C interface picks
    it: ``3 kind + kernel``, kind 0 f32 (also without a net), 1 bf16, 2
    bf16 on the ring, 3-5 the same with the workspace; kernel 0 CFR, 1 FP,
    2 the two-group CFR; at :data:`WIDE_WIDTH` the wide units,
    ``WIDE_UNIT0 + 2 mma + fp``."""
    mma = plan.bf16 and has_net
    if plan.width > KERNEL_WIDTH:
        return WIDE_UNIT0 + 2 * int(mma) + int(not params.use_cfr)
    kind = (3 if plan.workspace else 0) + ((2 if plan.ring else 1) if mma
                                           else 0)
    kernel = 2 if plan.groups == 2 else 0 if params.use_cfr else 1
    return 3 * kind + kernel


solve.launches = 0
solve.launches_by_kernel = dict.fromkeys(KERNEL_NAMES, 0)
# Launches by the padded width their units run at (KERNEL_WIDTHS).
solve.launches_by_width = dict.fromkeys(KERNEL_WIDTHS, 0)
solve.last_lane_block = None
solve.last_layout = None
# Set to a list to collect ``(kernel name, start, end)`` CUDA events around
# every launch (read the times after a synchronise); None collects nothing.
solve.events = None


def _declare(lib) -> None:
    lib.grid2_cfr_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.grid2_cfr_smem_bytes.restype = ctypes.c_int
    lib.grid2_cfr_workspace_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.grid2_cfr_workspace_bytes.restype = ctypes.c_int
    lib.grid2_cfr_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
    ]
    lib.grid2_cfr_launch.restype = ctypes.c_int
    lib.grid2_cfr_error_string.argtypes = [ctypes.c_int]
    lib.grid2_cfr_error_string.restype = ctypes.c_char_p
