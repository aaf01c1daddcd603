"""The whole depth-2 subgame solve, CFR or fictitious play, as one CUDA
kernel on the card.

Counterpart of ``rebel_tpu/solving/grid2p.py`` (``Grid2PallasSolver``).
Two functions share one contract:

* :func:`solve_reference`: the plain PyTorch version (the batch-last
  solver of :mod:`rebel_tpu_torch.solving.grid2b` plus the stop-iteration
  snapshot scan), on any device;
* :func:`solve`: launches ``kernels/grid2_cfr.cu`` for CUDA tensors (its
  CFR instantiation ``grid2_cfr`` when ``params.use_cfr``, else its
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
elementwise math is f32; GELU is the Abramowitz-Stegun erf form in f32 mode
and the fast polynomial in bf16 mode (the reference kernel's ``gelu="auto"``
policy, the only one its training runs use).
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


def kernel_mlp(net: CFVNet, net_compute_dtype=torch.float32):
    """``x [Q, N] -> [H, N]`` through ``net`` with the kernel's numerics
    (operands in ``net_compute_dtype``, f32 accumulation, one-pass
    LayerNorm, f32 GELU: the fast polynomial with bf16 operands)."""
    bf16 = net_compute_dtype == torch.bfloat16
    act = gelu_fast if bf16 else gelu_erf

    def rnd(t):
        # bf16 operands, products exact in f32, f32 sums.
        return t.to(torch.bfloat16).float() if bf16 else t

    def mlp(x: torch.Tensor) -> torch.Tensor:
        x = x.float().T  # [N, Q]
        for lin, ln in net.hidden_layers():
            x = rnd(x) @ rnd(lin.weight.float()).T + lin.bias.float()
            if ln is not None:
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


def solve_reference(game: LiarsDice, params: SubgameSolvingParams,
                    bids: torch.Tensor, players: torch.Tensor,
                    beliefs: torch.Tensor, t_stop: torch.Tensor,
                    net: CFVNet | None = None,
                    net_compute_dtype: torch.dtype = torch.float32
                    ) -> Grid2Outputs:
    """Plain PyTorch version of the fused solve (see module doc)."""
    return solve_loop(
        game, params, bids, players, beliefs, t_stop,
        None if net is None else kernel_mlp(net, net_compute_dtype))


@torch.no_grad()
def solve(game: LiarsDice, params: SubgameSolvingParams,
          bids: torch.Tensor, players: torch.Tensor, beliefs: torch.Tensor,
          t_stop: torch.Tensor, net: CFVNet | None = None,
          net_compute_dtype: torch.dtype = torch.float32,
          lane_block: int = 8) -> Grid2Outputs:
    """The fused solve: one launch of ``kernels/grid2_cfr.cu`` runs all
    ``num_iters`` iterations for CUDA inputs (``B % lane_block == 0``);
    CPU inputs take :func:`solve_reference`.  Adds one per kernel launch
    to ``solve.launches`` and to ``solve.launches_by_kernel`` under
    ``"grid2_cfr"`` or ``"grid2_fp"``; while ``solve.events`` is a list,
    appends a pair of CUDA events around each launch."""
    dev = beliefs.device
    if dev.type == "cpu":
        return solve_reference(game, params, bids, players, beliefs, t_stop,
                               net, net_compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"solve runs on cuda or cpu tensors, not {dev}")
    _check_inputs(game, params, bids, players, beliefs, t_stop)
    from rebel_tpu_torch.kernels import build

    A, H, F = game.num_actions, game.num_hands, game.num_faces
    Q = game.query_size
    Qpad = (Q + 3) // 4 * 4
    B = bids.shape[0]
    if B % lane_block:
        raise ValueError(f"batch {B} is not a multiple of lane_block "
                         f"{lane_block}")
    bf16 = net_compute_dtype == torch.bfloat16
    if net_compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("net_compute_dtype must be float32 or bfloat16")
    wdt = torch.bfloat16 if bf16 else torch.float32

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
        if n_hidden not in KERNEL_HIDDEN or not 1 <= n_layers <= 8:
            raise ValueError(
                f"the kernel takes 1-8 hidden layers of width "
                f"{KERNEL_HIDDEN}, not {n_layers} x {n_hidden}"
            )
        for k, (lin, ln) in enumerate(net.hidden_layers()):
            w = lin.weight.detach().T.to(device=dev, dtype=torch.float32)
            if k == 0:  # pad the input rows to a multiple of 4
                w = torch.cat([w, w.new_zeros(Qpad - Q, n_hidden)])
            keep += [w.to(wdt).contiguous(), f32(lin.bias.detach())]
            keep += ([f32(ln.weight.detach()), f32(ln.bias.detach())]
                     if ln is not None else [None, None])
        keep += [net.output.weight.detach().T.to(dev, wdt).contiguous(),
                 f32(net.output.bias.detach())]

    ints = [B, lane_block, A, H, F, game.total_num_dice, Q, Qpad, n_hidden,
            n_layers, params.num_iters, int(params.linear_update),
            int(params.dcfr), int(net is not None), int(bf16),
            int(not params.use_cfr), int(params.optimistic)]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    lib = build.load("grid2_cfr")
    _declare(lib)
    smem = lib.grid2_cfr_smem_bytes(c_ints)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"lane_block {lane_block} needs {smem} B of shared memory per "
            f"block, more than {SMEM_LIMIT}; use a smaller lane_block"
        )
    ptrs = (ctypes.c_void_p * len(keep))(
        *[0 if t is None else t.data_ptr() for t in keep]
    )
    floats = (ctypes.c_float * 2)(params.dcfr_alpha, params.dcfr_beta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    events = None
    if solve.events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    err = lib.grid2_cfr_launch(ptrs, c_ints, floats, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel_name(params)} launch failed: "
            + lib.grid2_cfr_error_string(err).decode()
        )
    if events is not None:
        events[1].record()
        solve.events.append((kernel_name(params), *events))
    solve.launches += 1
    solve.launches_by_kernel[kernel_name(params)] += 1
    return Grid2Outputs(rvm=rvm, snap0=snap0, snap1=snap1)


def kernel_name(params: SubgameSolvingParams) -> str:
    """The instantiation of the fused kernel that solves ``params``."""
    return "grid2_cfr" if params.use_cfr else "grid2_fp"


solve.launches = 0
solve.launches_by_kernel = {"grid2_cfr": 0, "grid2_fp": 0}
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
