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

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.solving.grid2b import Grid2BatchSolver, RootCtxB
from rebel_tpu_torch.solving.params import SubgameSolvingParams

# Net widths the kernel is instantiated for (NH = 128 * columns/thread);
# another width comes with its check on the card.
KERNEL_HIDDEN = (256,)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# The tensor-core MLP (bf16 operands): query rows of a warpgroup's tile,
# warpgroups of a block, and the deepest first layer (Q rounded up to 16).
MMA_ROWS = 64
WARPGROUPS = 2
MAX_K0 = 64


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


def _core_matrices(w: torch.Tensor, n_pad: int, k_pad: int) -> torch.Tensor:
    """``w [N, K]`` zero-padded to ``[n_pad, k_pad]`` and cut into 8 x 8
    core matrices ``[n_pad / 8, k_pad / 8, 8, 8]``: the byte order in which
    the kernel's tensor-core instructions read a K-major operand."""
    n, k = w.shape
    w = torch.nn.functional.pad(w, (0, k_pad - k, 0, n_pad - n))
    return w.reshape(n_pad // 8, 8, k_pad // 8, 8).permute(0, 2, 1, 3)


def mlp_block_shapes(game: LiarsDice, n_hidden: int, n_layers: int):
    """``[(N, K), ...]`` of the weights in the bf16 MLP block, hidden layers
    then the head, padded as the kernel reads them: K of the first layer is
    the query size rounded up to 16, N of the head the hands rounded up to
    8."""
    k0, hn = _ceil(game.query_size, 16), _ceil(game.num_hands, 8)
    return ([(n_hidden, k0 if k == 0 else n_hidden) for k in range(n_layers)]
            + [(hn, n_hidden)])


def mlp_block_bytes(game: LiarsDice, n_hidden: int, n_layers: int) -> int:
    """Bytes of :func:`pack_mlp_weights`'s block: bf16 weights, then f32
    bias, LayerNorm scale and bias of each hidden layer and the head's
    bias."""
    shapes = mlp_block_shapes(game, n_hidden, n_layers)
    return (sum(2 * n * k for n, k in shapes)
            + 4 * (3 * n_layers * n_hidden + shapes[-1][0]))


@torch.no_grad()
def pack_mlp_weights(net: CFVNet) -> torch.Tensor:
    """The net as the kernel's bf16 MLP keeps it in shared memory: one
    ``uint8`` block on the net's device that the kernel copies as it is.
    Per hidden layer, then the head: ``weight [N, K]`` (the transpose of
    the product's ``[K, N]``) rounded to bf16, zero-padded to
    :func:`mlp_block_shapes` and cut by :func:`_core_matrices`; then in
    f32 each hidden layer's bias, LayerNorm scale and LayerNorm bias (zeros
    without LayerNorm) and the head's bias, zero-padded to its N."""
    shapes = mlp_block_shapes(net.game, net.n_hidden, net.n_layers)
    layers = [lin for lin, _ in net.hidden_layers()] + [net.output]
    parts = [_core_matrices(lin.weight.float(), n, k).to(torch.bfloat16)
             .reshape(-1).view(torch.uint8)
             for lin, (n, k) in zip(layers, shapes)]
    f32 = []
    for lin, ln in net.hidden_layers():
        zero = torch.zeros_like(lin.bias)
        f32 += [lin.bias, zero if ln is None else ln.weight,
                zero if ln is None else ln.bias]
    hn = shapes[-1][0]
    f32.append(torch.nn.functional.pad(net.output.bias, (0, hn - len(
        net.output.bias))))
    parts.append(torch.cat([x.float() for x in f32]).view(torch.uint8))
    return torch.cat(parts)


def smem_layout(game: LiarsDice, lane_block: int, use_cfr: bool,
                n_hidden: int, n_layers: int, bf16: bool, groups: int = 1,
                mlp_chunks: int = 1) -> dict:
    """Bytes of a block's shared memory by part, as the kernel's
    ``make_layout()`` lays it out (the wrapper holds the two equal on the
    card): ``mlp`` (bf16 with a net: the packed MLP block and its
    barrier), ``tables`` (pair tables and payoff), ``lanes`` (the solver
    state of all lanes), ``staging`` (f32 with a net: the activations of a
    group of pairs) and ``total``.  ``n_layers`` 0: no net."""
    A, H = game.num_actions, game.num_hands
    P = len(pseudo_leaf_pairs(game))
    words = lambda *ns: sum(_ceil(n, 4) for n in ns)
    net = n_layers > 0
    mma = net and bf16
    mlp = words(mlp_block_bytes(game, n_hidden, n_layers) // 4, 2) if mma else 0
    tables = words(P, P, A * A, A * H * H)
    LB = lane_block // groups
    state = [LB, LB, LB, LB * A, LB * 2 * H, LB * H * H, LB * H * A,
             LB * H * A, LB * A * H * A, LB * A * H * A, LB * 2 * H, LB * H,
             LB * A * H, LB * A * H, LB * H, P * LB * H, P * LB * H, P * LB,
             P * LB * H, LB * A * H, LB * H]
    if not use_cfr:  # the average policy
        state += [LB * H * A, LB * A * H * A]
    lanes = words(*state)
    staging = 0
    if net and not mma:
        rows = _ceil(-(-P // mlp_chunks) * LB, 16 * (256 // groups) // 128)
        qpad = _ceil(game.query_size, 4)
        staging = words(rows * qpad, rows * n_hidden, rows * n_hidden)
    parts = dict(mlp=mlp, tables=tables, lanes=groups * lanes,
                 staging=groups * staging)
    parts["total"] = sum(parts.values())
    return {k: 4 * v for k, v in parts.items()}


def default_mlp_chunks(n_pairs: int, lane_block: int, groups: int,
                       mma: bool) -> int:
    """``mlp_chunks`` when the caller gives none.  The tensor-core MLP
    (``mma``, bf16 with a net) stages nothing, so only its row padding
    counts: the fewest groups of pairs that take the fewest turns of the
    block's warpgroups over 64-row tiles (1 at 1x4f for every lane block
    up to 16).  The f32 MLP stages a group's activations: as many pairs at
    a time as fill one row tile of ``dense()`` (32 rows a block)."""
    if not mma:
        return -(-n_pairs // max(1, 32 // lane_block))
    lanes, wgs = lane_block // groups, WARPGROUPS // groups

    def turns(chunks):
        per = -(-n_pairs // chunks)
        tiles = -(-per * lanes // MMA_ROWS)
        return -(-n_pairs // per) * -(-tiles // wgs)

    return min(range(1, n_pairs + 1), key=lambda c: (turns(c), c))


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


def kernel_plan(game: LiarsDice, params: SubgameSolvingParams,
                net: CFVNet | None, net_compute_dtype: torch.dtype,
                batch: int, lane_block: int, mlp_chunks: int | None = None,
                interleave: int = 1, gelu: str = "auto",
                ablate: str = "") -> KernelPlan:
    """What :func:`solve` launches for these options, worked out before
    anything is built or launched.  Raises ``ValueError`` on an option the
    kernel does not take and on a layout that does not fit a block's
    shared memory (never shrinks the lane block, never falls back)."""
    act, groups = _check_knobs(params, net, net_compute_dtype, lane_block,
                               mlp_chunks, interleave, gelu, ablate)
    if net_compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("net_compute_dtype must be float32 or bfloat16")
    if batch % lane_block:
        raise ValueError(f"batch {batch} is not a multiple of lane_block "
                         f"{lane_block}")
    bf16 = net_compute_dtype == torch.bfloat16
    n_hidden = n_layers = 0
    if net is not None:
        n_hidden, n_layers = net.n_hidden, net.n_layers
        if n_hidden not in KERNEL_HIDDEN or not 1 <= n_layers <= 8:
            raise ValueError(
                f"the kernel takes 1-8 hidden layers of width "
                f"{KERNEL_HIDDEN}, not {n_layers} x {n_hidden}"
            )
        if bf16 and _ceil(game.query_size, 16) > MAX_K0:
            raise ValueError(
                f"the tensor-core MLP takes queries of up to {MAX_K0} "
                f"values, not {game.query_size}")
    mma = bf16 and net is not None
    if mlp_chunks is None:
        mlp_chunks = default_mlp_chunks(len(pseudo_leaf_pairs(game)),
                                        lane_block, groups, mma)
    need = smem_layout(game, lane_block, params.use_cfr, n_hidden, n_layers,
                       bf16, groups, mlp_chunks)["total"]
    if need > SMEM_LIMIT:
        more = ("use a smaller lane_block or fewer hidden layers" if mma
                else "use a smaller lane_block or more mlp_chunks")
        raise ValueError(
            f"lane_block {lane_block} with mlp_chunks {mlp_chunks} needs "
            f"{need} B of shared memory per block, more than {SMEM_LIMIT}; "
            f"{more}")
    return KernelPlan(act, groups, mlp_chunks, bf16, need)


# Lane blocks choose_lane_block tries, largest first.  Blocks above 8 fit
# some 1x4f layouts but are a question of speed, not of fit.
LANE_BLOCKS = (8, 4, 2, 1)


def choose_lane_block(game: LiarsDice, params: SubgameSolvingParams,
                      net: CFVNet | None, net_compute_dtype: torch.dtype,
                      batch: int, interleave: int = 1, gelu: str = "auto",
                      ablate: str = "", mlp_chunks: int | None = None) -> int:
    """The largest of :data:`LANE_BLOCKS` that divides ``batch`` and whose
    layout fits a block's shared memory (:func:`kernel_plan`); with
    ``interleave=2`` where it applies, only even blocks.  Chosen before
    anything is built or launched; raises ``kernel_plan``'s
    ``ValueError`` for the smallest candidate when none fits."""
    groups = effective_interleave(params, net is not None, interleave, None)
    blocks = [lb for lb in LANE_BLOCKS
              if batch % lb == 0 and lb % groups == 0]
    if not blocks:
        raise ValueError(f"no lane block of {LANE_BLOCKS} divides batch "
                         f"{batch}" + (" into even blocks" if groups == 2
                                       else ""))
    plan = lambda lb: kernel_plan(game, params, net, net_compute_dtype,
                                  batch, lb, mlp_chunks, interleave, gelu,
                                  ablate)
    for lb in blocks[:-1]:
        try:
            plan(lb)
            return lb
        except ValueError:
            pass
    plan(blocks[-1])  # raises when not even the smallest fits
    return blocks[-1]


@torch.no_grad()
def solve(game: LiarsDice, params: SubgameSolvingParams,
          bids: torch.Tensor, players: torch.Tensor, beliefs: torch.Tensor,
          t_stop: torch.Tensor, net: CFVNet | None = None,
          net_compute_dtype: torch.dtype = torch.float32,
          lane_block: int | None = None, mlp_chunks: int | None = None,
          interleave: int = 1, gelu: str = "auto",
          ablate: str = "") -> Grid2Outputs:
    """The fused solve: one launch of ``kernels/grid2_cfr.cu`` runs all
    ``num_iters`` iterations for CUDA inputs (``B % lane_block == 0``);
    CPU inputs take :func:`solve_reference`.  Adds one per kernel launch
    to ``solve.launches`` and to ``solve.launches_by_kernel`` under
    :func:`kernel_name`; while ``solve.events`` is a list, appends a pair
    of CUDA events around each launch.  With bf16 operands and a net the
    kernel runs the MLP on the tensor cores from the block that
    :func:`pack_mlp_weights` lays out.  Options whose layout does not fit
    a block's shared memory raise (:func:`kernel_plan`) before anything is
    built or launched."""
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
    from rebel_tpu_torch.kernels import build

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

    n_hidden = n_layers = 0
    if net is not None:
        n_hidden, n_layers = net.n_hidden, net.n_layers
        # f32 weights for dense(); bf16 ones go in the packed block, which
        # holds the biases and LayerNorm parameters too (the kernel reads
        # ln_scale only for whether the layer has LayerNorm).
        for k, (lin, ln) in enumerate(net.hidden_layers()):
            w = None
            if not mma:
                w = lin.weight.detach().T.to(device=dev, dtype=torch.float32)
                if k == 0:  # pad the input rows to a multiple of 4
                    w = torch.cat([w, w.new_zeros(Qpad - Q, n_hidden)])
                w = w.contiguous()
            keep += [w, f32(lin.bias.detach())]
            keep += ([f32(ln.weight.detach()), f32(ln.bias.detach())]
                     if ln is not None else [None, None])
        keep += [None if mma else f32(net.output.weight.detach().T),
                 f32(net.output.bias.detach())]
        if mma:
            keep.append(pack_mlp_weights(net).to(dev))

    ints = [B, lane_block, A, H, F, game.total_num_dice, Q, Qpad, n_hidden,
            n_layers, params.num_iters, int(params.linear_update),
            int(params.dcfr), int(net is not None), int(plan.bf16),
            int(not params.use_cfr), int(params.optimistic),
            ACTIVATIONS.index(plan.act), int(ablate != "noln"),
            plan.mlp_chunks, plan.groups]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    lib = build.load("grid2_cfr")
    _declare(lib)
    smem = lib.grid2_cfr_smem_bytes(c_ints)
    if smem != plan.smem:
        raise RuntimeError(
            f"the kernel lays out {smem} B of shared memory and smem_layout "
            f"reckons {plan.smem} B: the two have come apart")
    ptrs = (ctypes.c_void_p * len(keep))(
        *[0 if t is None else t.data_ptr() for t in keep]
    )
    floats = (ctypes.c_float * 2)(params.dcfr_alpha, params.dcfr_beta)
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
    solve.last_lane_block = lane_block
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
solve.launches = 0
solve.launches_by_kernel = dict.fromkeys(KERNEL_NAMES, 0)
solve.last_lane_block = None
# Set to a list to collect ``(kernel name, start, end)`` CUDA events around
# every launch (read the times after a synchronise); None collects nothing.
solve.events = None


def _declare(lib) -> None:
    lib.grid2_cfr_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.grid2_cfr_smem_bytes.restype = ctypes.c_int
    lib.grid2_cfr_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
    ]
    lib.grid2_cfr_launch.restype = ctypes.c_int
    lib.grid2_cfr_error_string.argtypes = [ctypes.c_int]
    lib.grid2_cfr_error_string.restype = ctypes.c_char_p
