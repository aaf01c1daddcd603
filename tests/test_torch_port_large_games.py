"""The fused solve at the games of up to 64 hands and 64 actions.

``kernels/grid2_cfr.cu`` takes every game of at most 64 hands and 64
actions (queries of at most 256 values): a row wider than a warp is dealt
two values a lane, and a game whose lanes' state fits no lane block's
shared memory keeps part of it in a device workspace.  The kernel runs on
the card only (``chip_smoke.py large-games``); here, on the CPU:

* ``grid2p.solve_reference``, the kernel's yardstick on the card, against
  the JAX package's ``Grid2PallasSolver`` in interpret mode at 2x4f,
  2x5f, 3x3f, 2x6f, 3x4f and 1x16f, CFR and FP, with a narrow net (16
  wide, one hidden layer) and without a net at 2x6f, on 4 lanes over 8
  iterations at atol 1e-5 (the tolerance of the smaller games' test,
  ``test_torch_port_games_parity.py``);
* the slice as a whole: ``grid2p.solve`` and ``advance`` for three steps
  at 2x5f against ``FastPallasEngine`` with its draws injected;
* the plan: every game that launched before keeps its lane block and its
  layout, the new games take the workspace within the shared-memory
  limit, and a game over the limits is refused before anything is built;
* the bf16 block at the new query sizes, the work split's multipliers at
  the new sizes, and ``grid2p.deal_wide`` (the kernel's dealing of a wide
  row to a warp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.selfplay.fast_runner import FastPallasEngine, sample_action
from rebel_tpu.selfplay.runner import EpisodeState as JEpisodeState
from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRSP
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.selfplay.fast_runner import advance
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

LANES = 4
ITERS = 8
GAMES = [(2, 4), (2, 5), (3, 3), (2, 6), (3, 4), (1, 16)]


def _inputs(game, seed):
    """Roots spread over the bids (the initial bid -1 and the last one
    before the liar call included), both players, Dirichlet beliefs and
    stop iterations at both ends of the range."""
    rng = np.random.RandomState(seed)
    A = game.num_actions
    bids = np.array([-1, 0, A // 2, A - 2], np.int32)
    players = np.array([0, 1, 1, 0], np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(LANES, 2)).astype(
        np.float32)
    t_stop = np.array([0, ITERS, rng.randint(1, ITERS), rng.randint(1, ITERS)],
                      np.int32)
    return bids, players, beliefs, t_stop


@pytest.mark.parametrize("dice,faces,solver,net_mode",
                         [(*g, s, "16x1") for g in GAMES for s in ("cfr", "fp")]
                         + [(2, 6, "cfr", "nonet"), (2, 6, "fp", "nonet")])
def test_solve_reference_matches_pallas_at_large_games(dice, faces, solver,
                                                       net_mode):
    game = LiarsDice(dice, faces)
    kw = dict(num_iters=ITERS, max_depth=2, use_cfr=solver == "cfr",
              linear_update=True)
    bids, players, beliefs, t_stop = _inputs(game, 10 * dice + faces)
    params_j = net = None
    if net_mode != "nonet":
        spec = CFVNetSpec(game=JLiarsDice(dice, faces), n_hidden=16,
                          n_layers=1, use_layer_norm=True)
        params_j = jax.tree.map(lambda x: np.asarray(x, np.float32),
                                spec.init_params(jax.random.PRNGKey(3)))
        net = net_from_state_dict(from_flax(params_j), game)
    ref = Grid2PallasSolver(
        game=JLiarsDice(dice, faces), params=JParams(**kw), lane_block=LANES,
        interpret=True,
    ).solve(bids, players, beliefs, t_stop, params_j)
    out = grid2p.solve_reference(
        game, SubgameSolvingParams(**kw), torch.as_tensor(bids),
        torch.as_tensor(players), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net)
    differ = np.zeros(LANES, bool)
    for name in ("rvm", "snap0", "snap1"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if solver == "cfr":
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        differ |= np.abs(got - want).reshape(LANES, -1).max(1) > 1e-5
    # FP: no lane is left out; a flipped best response would show here.
    assert differ.sum() == 0, f"lanes that differ: {np.nonzero(differ)}"


# ------------------------------------------------------ the whole slice

SUB = dict(num_iters=4, max_depth=2, linear_update=True, use_cfr=True)
B = 4


def _jax_draws(jcfg, ep, keys, params, lane_block):
    """The stop iterations and actions ``FastPallasEngine.batch_step``
    draws from ``keys`` (its solve key is split slot 0, the walk uses
    slots 1-3)."""
    game = jcfg.game
    sub = jcfg.subgame_params
    k_solve = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, sub.num_iters + 1))(
        k_solve)
    sol = Grid2PallasSolver(game=game, params=sub, lane_block=lane_block,
                            interpret=True).solve(
        ep.root_bid, ep.root_player, ep.beliefs, t, params)

    def lane(e, key, p0, p1):
        _, k_br, k_a1, k_a2 = jax.random.split(key, 4)
        root = JRootCtx.of(game, e.root_bid, e.root_player)
        br = jax.random.randint(k_br, (), 0, 2)
        actor0 = root.player
        a1 = sample_action(jcfg, k_a1, p0, root.mask, e.beliefs[actor0],
                           actor0 == br)
        actor1 = (root.player + 1) % 2
        m1 = (jnp.arange(game.num_actions) > a1) & (a1 != game.liar_call)
        a2 = sample_action(jcfg, k_a2, p1[a1], m1, e.beliefs[actor1],
                           actor1 == br)
        return a1, a2

    a1, a2 = jax.vmap(lane)(ep, keys, sol.snap0, sol.snap1)
    return t, a1, a2


def test_engine_step_matches_pallas_engine_at_2x5():
    """Three self-play steps at 2x5f (25 hands: a query of 73 values):
    the port's solve and walk with the JAX engine's draws injected give
    its values, queries and next roots at the JAX package's tolerances
    (values 2e-5, queries 1e-6)."""
    jcfg = JRSP(num_dice=2, num_faces=5, subgame_params=JParams(**SUB),
                random_action_prob=0.25, sample_leaf=True)
    cfg = RecursiveSolvingParams(
        num_dice=2, num_faces=5, subgame_params=SubgameSolvingParams(**SUB),
        random_action_prob=0.25, sample_leaf=True)
    game = cfg.game
    spec = CFVNetSpec(game=jcfg.game, n_hidden=16, n_layers=1)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(25)))
    net = net_from_state_dict(from_flax(params), game)
    jeng = FastPallasEngine(cfg=jcfg, dtype=jnp.float32, lane_block=B,
                            interpret=True)
    ep_j = JEpisodeState.initial_batch(jcfg.game, B, jnp.float32)
    for step in range(3):
        keys = jax.random.split(jax.random.PRNGKey(250 + step), B)
        new_j, out_j = jeng.batch_step(ep_j, keys, params)
        t, a1, a2 = _jax_draws(jcfg, ep_j, keys, params, B)
        ep = EpisodeState(
            root_bid=torch.as_tensor(np.array(ep_j.root_bid)).long(),
            root_player=torch.as_tensor(np.array(ep_j.root_player)).long(),
            beliefs=torch.as_tensor(np.array(ep_j.beliefs, np.float32)))
        sol = grid2p.solve(game, cfg.subgame_params, ep.root_bid,
                           ep.root_player, ep.beliefs,
                           torch.as_tensor(np.array(t)), net)
        new, out = advance(cfg, ep, sol.snap0, sol.snap1, sol.rvm,
                           torch.as_tensor(np.array(a1)).long(),
                           torch.as_tensor(np.array(a2)).long())
        np.testing.assert_allclose(out.values.numpy(),
                                   np.asarray(out_j.values), atol=2e-5)
        np.testing.assert_allclose(out.queries.numpy(),
                                   np.asarray(out_j.queries), atol=1e-6)
        np.testing.assert_array_equal(out.ended.numpy(),
                                      np.asarray(out_j.ended))
        np.testing.assert_array_equal(new.root_bid.numpy(),
                                      np.asarray(new_j.root_bid))
        np.testing.assert_array_equal(new.root_player.numpy(),
                                      np.asarray(new_j.root_player))
        np.testing.assert_allclose(new.beliefs.numpy(),
                                   np.asarray(new_j.beliefs), atol=2e-5)
        ep_j = new_j
    assert int(np.asarray(ep_j.root_bid).max()) >= 0  # left the root


# ------------------------------------------------------------- the plan


def _params(use_cfr):
    return SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=use_cfr,
                                linear_update=True)


def _net(game, n_layers=2):
    return CFVNet(game, 256, n_layers, True,
                  generator=torch.Generator().manual_seed(0))


# Every game that launches without the workspace, 256x2 net, B=1024: the
# lane block and layout the wrapper takes for bf16 and f32 (CFR and FP
# alike).
KEPT = {(1, 4): ((8, "resident"), (8, "resident")),
        (1, 5): ((8, "resident"), (8, "resident")),
        (1, 6): ((4, "resident"), (4, "resident")),
        (2, 3): ((2, "resident"), (4, "resident")),
        (2, 4): ((1, "ring"), (1, "resident")),
        (4, 2): ((1, "ring"), (1, "resident")),
        (3, 2): ((4, "resident"), (4, "resident")),
        (1, 8): ((2, "resident"), (2, "resident")),
        (1, 12): ((1, "ring"), None)}


@pytest.mark.parametrize("dice,faces", list(KEPT))
def test_games_that_launched_keep_their_plan(dice, faces):
    game = LiarsDice(dice, faces)
    net = _net(game)
    for use_cfr in (True, False):
        for dtype, want in zip((torch.bfloat16, torch.float32),
                               KEPT[dice, faces]):
            if want is None:  # it never launched: 1x12f f32 is new
                assert grid2p.needs_workspace(game, _params(use_cfr), net,
                                              dtype)
                continue
            assert not grid2p.needs_workspace(game, _params(use_cfr), net,
                                              dtype)
            lb = grid2p.choose_lane_block(game, _params(use_cfr), net, dtype,
                                          1024)
            plan = grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                      1024, lb)
            assert (lb, plan.layout) == want
            assert (plan.workspace, plan.ws_bytes) == (0, 0)


# The new games, 256x2 net, B=1024: (lane block, layout) for bf16 and f32.
TAKEN = {(2, 5): ((1, "ring+workspace2"), (1, "resident+workspace2")),
         (3, 3): ((1, "ring+workspace2"), (1, "resident+workspace2")),
         (2, 6): ((1, "ring+workspace3"), (1, "resident+workspace3")),
         (3, 4): ((1, "ring+workspace4"), (1, "resident+workspace5")),
         (1, 16): ((1, "ring+workspace2"), (1, "resident+workspace3"))}


@pytest.mark.parametrize("dice,faces", list(TAKEN))
def test_new_games_take_the_workspace(dice, faces):
    """Each takes the workspace's shallowest level at which a block fits
    (resident weights before the ring), within the shared-memory limit,
    with the workspace bytes ``smem_layout`` reports, at the smallest
    lane block; the level below fits no lane block."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    for use_cfr in (True, False):
        sub = _params(use_cfr)
        for dtype, want in zip((torch.bfloat16, torch.float32),
                               TAKEN[dice, faces]):
            bf16 = dtype == torch.bfloat16
            assert grid2p.needs_workspace(game, sub, net, dtype)
            lb = grid2p.choose_lane_block(game, sub, net, dtype, 1024)
            plan = grid2p.kernel_plan(game, sub, net, dtype, 1024, lb)
            assert (lb, plan.layout) == want
            got = grid2p.smem_layout(game, lb, use_cfr, 256, 2, bf16,
                                     ring=plan.ring,
                                     workspace=plan.workspace)
            assert plan.smem == got["total"] <= grid2p.SMEM_LIMIT
            assert plan.ws_bytes == got["workspace"] > 0
            for block in grid2p.LANE_BLOCKS:
                for ring in {False, plan.ring}:
                    below = grid2p.smem_layout(
                        game, block, use_cfr, 256, 2, bf16, ring=ring,
                        workspace=plan.workspace - 1)
                    assert below["total"] > grid2p.SMEM_LIMIT


def test_workspace_levels_move_state_out_of_shared_memory():
    """At 2x6f, lane block 1, bf16 on the ring: each level moves its arrays
    from shared memory to the workspace, byte for byte; the payoff table
    (level 1) is the wrapper's tensor, in no part of the workspace."""
    game = LiarsDice(2, 6)
    A, H = game.num_actions, game.num_hands
    P = len(grid2p.pseudo_leaf_pairs(game))
    lay = [grid2p.smem_layout(game, 1, True, 256, 2, True, ring=True,
                              workspace=level) for level in range(5)]
    assert "workspace" not in lay[0] and "scratch" not in lay[0]
    # Every level has the warps' reach rows (REACH_NB items of three rows
    # of H values, an odd number of words apart) and the group's WsBody in
    # shared memory; the root bid's win table [H, H] is computed where it
    # is needed at every level, and kept nowhere.
    scratch = 4 * (grid2p.WARPS * 3 * grid2p.REACH_NB * (H | 1)
                   + grid2p.WS_BODY_WORDS)
    assert all(lay[level]["scratch"] == scratch for level in range(1, 5))
    moved = [0, 4 * A * H * H + 4 * H * H - scratch, 2 * 4 * A * H * A,
             4 * (2 * P * H + P), 4 * (2 * H * A + 2 * A * H)]
    # The level-1 arrays keep only their cells a2 > a1 in the workspace.
    stored = {**dict(enumerate(moved)),
              1: 0, 2: 2 * 4 * grid2p.level1_cells(A) * H}
    assert grid2p.level1_cells(A) == 300
    for level in range(1, 5):
        assert lay[level - 1]["total"] - lay[level]["total"] == moved[level]
        assert lay[level]["workspace"] - lay[level - 1].get(
            "workspace", 0) == stored[level]
    # f32: level 5 streams the first layer through the ring.
    f32 = [grid2p.smem_layout(game, 1, True, 256, 2, False, workspace=level)
           for level in (4, 5)]
    assert f32[0]["mlp"] - f32[1]["mlp"] == 4 * 100 * 256
    assert f32[0]["workspace"] == f32[1]["workspace"]
    # bf16: level 5 keeps the head [40, 256] in device memory; no launch
    # takes a level 6.
    bf16 = [grid2p.smem_layout(game, 1, True, 256, 2, True, ring=True,
                               workspace=level) for level in (4, 5)]
    assert bf16[0]["mlp"] - bf16[1]["mlp"] == 2 * 40 * 256
    assert bf16[0]["workspace"] == bf16[1]["workspace"]
    for dtype_bf16 in (True, False):
        with pytest.raises(ValueError, match="workspace level 6"):
            grid2p.smem_layout(game, 1, True, 256, 2, dtype_bf16,
                               workspace=6)


def test_forced_workspace_plans_every_launch():
    """``_force_workspace`` (the chip checks' bit-for-bit comparisons) puts
    the arrays of its level in the workspace at any game, at most the
    launch's deepest level; outside the block the plan is as before."""
    game = LiarsDice(1, 4)
    net = _net(game)
    before = grid2p.kernel_plan(game, _params(True), net, torch.bfloat16,
                                1024, 8)
    with grid2p._force_workspace(5):
        bf16 = grid2p.kernel_plan(game, _params(True), net, torch.bfloat16,
                                  1024, 8)
        f32 = grid2p.kernel_plan(game, _params(False), net, torch.float32,
                                 1024, 8)
        nonet = grid2p.kernel_plan(game, _params(True), None, torch.float32,
                                   1024, 8)
    assert (bf16.layout, f32.layout, nonet.layout) == (
        "resident+workspace5", "resident+workspace5", "resident+workspace4")
    assert bf16.smem < before.smem and bf16.ws_bytes > 0
    assert grid2p.kernel_plan(game, _params(True), net, torch.bfloat16,
                              1024, 8) == before


@pytest.mark.parametrize("dice,faces,match", [
    (5, 3, "at most 128 hands, not 243"),
    (3, 5, "queries of up to 256 values, not 283"),
    (2, 11, "queries of up to 256 values, not 289"),
    (1, 32, "at most 64 actions, not 65")])
@pytest.mark.parametrize("with_net", [False, True])
def test_games_over_the_limits_are_refused(dice, faces, match, with_net):
    """Refused by ``kernel_plan`` and ``choose_lane_block`` for every lane
    block, bf16 and f32, CFR and FP, with a net and without, before
    anything is built or launched, naming the ROADMAP's Queue 6 item."""
    game = LiarsDice(dice, faces)
    net = _net(game) if with_net else None
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=match):
            grid2p.choose_lane_block(game, _params(True), net, dtype, 1024)
        for lb in (1, 8):
            for use_cfr in (True, False):
                with pytest.raises(ValueError, match=match):
                    grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                       1024, lb)
        with pytest.raises(ValueError, match="Queue 6 item 1"):
            grid2p.kernel_plan(game, _params(False), net, dtype, 1024, 1)


# ---------------------------------------------------- the MLP and the body


@pytest.mark.parametrize("dice,faces,query", [(2, 5, 73), (2, 6, 99),
                                              (3, 4, 155)])
@pytest.mark.parametrize("ring", [False, True])
def test_pack_round_trip_at_wide_queries(dice, faces, query, ring):
    """The bf16 block at first layers of 5, 7 and 10 k steps and heads of
    up to 64 hands: unpacking the core matrices gives every weight back,
    rounded to bf16, the padding zero."""
    game = LiarsDice(dice, faces)
    assert game.query_size == query
    net = _net(game, n_layers=3 if ring else 2)
    block = grid2p.pack_mlp_weights(net, 256, ring)
    shapes = grid2p.mlp_block_shapes(game, 256, net.n_layers)
    assert shapes[0] == (256, -(-query // 16) * 16)
    assert shapes[-1] == (-(-game.num_hands // 8) * 8, 256)
    assert block.numel() == grid2p.mlp_block_bytes(game, 256, net.n_layers)
    layers = [lin for lin, _ in net.hidden_layers()] + [net.output]
    order = [0, len(layers) - 1] if ring else list(range(len(layers)))
    off = 0
    for i in order:
        n, k = shapes[i]
        part = block[off:off + 2 * n * k].view(torch.bfloat16)
        got = part.reshape(n // 8, k // 8, 8, 8).permute(0, 2, 1, 3).reshape(
            n, k).float()
        w = layers[i].weight.detach().float()
        want = torch.zeros(n, k)
        want[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16).float()
        assert torch.equal(got, want), i
        off += 2 * n * k


def _split(i: np.ndarray, mul: int) -> np.ndarray:
    """The kernel's split(): the high 32 bits of the 64-bit product."""
    return (i.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32)


@pytest.mark.parametrize("dice,faces", [(2, 5), (3, 3), (2, 6), (3, 4),
                                        (1, 16)])
def test_work_split_at_large_games(dice, faces):
    """Every index the kernel divides at these games, for every lane block
    it may launch: the reach items, the (row, lane, hand) items, the root
    rows (lane, hand) and a wide row's lanes, each well inside the
    multipliers' bound i d < 2^32."""
    game = LiarsDice(dice, faces)
    A, H = game.num_actions, game.num_hands
    P = len(grid2p.pseudo_leaf_pairs(game))
    for lanes in (1, 2, 4, 8):
        mul_h, mul_a, mul_lb, mul_lbh = grid2p.work_split(game, lanes)
        e = np.arange(lanes * (P + A) + 32)
        if lanes > 1:
            np.testing.assert_array_equal(_split(e, mul_lb), e // lanes)
            assert e.max() * lanes < 2**32
        i = np.arange((A + 1) * lanes * H)
        np.testing.assert_array_equal(_split(i, mul_lbh), i // (lanes * H))
        r = i % (lanes * H)
        np.testing.assert_array_equal(_split(r, mul_h), r // H)
        assert i.max() * lanes * H < 2**32


@pytest.mark.parametrize("n", [1, 9, 32, 33, 36, 64, 65, 81, 100, 128])
def test_wide_rows_are_dealt_once_in_order(n):
    """``deal_wide``: a row of n values, lane l holding values l + 32 j,
    j < ceil(n / 32) (two registers up to 64 hands, four up to 128); the
    sums visit every value once, in index order, register 0's 32 values,
    then register 1's, and so on, and rows of 32 or fewer take one
    register a lane."""
    order = grid2p.deal_wide(n)
    assert [v for v, _, _ in order] == list(range(n))
    assert all(v == lane + 32 * j for v, lane, j in order)
    assert {lane for _, lane, _ in order} <= set(range(32))
    assert max(j for _, _, j in order) == -(-n // 32) - 1
    assert [j for _, _, j in order] == sorted(j for _, _, j in order)
    with pytest.raises(ValueError, match="128"):
        grid2p.deal_wide(129)


@pytest.mark.parametrize("dice,faces,dtype,wide", [
    (2, 6, torch.float32, True), (1, 16, torch.float32, True),
    (2, 5, torch.bfloat16, True), (2, 5, torch.float32, False),
    (2, 4, torch.bfloat16, False), (1, 12, torch.float32, False)])
def test_wide_games_take_only_the_workspace(dice, faces, dtype, wide):
    """Rows wider than a warp and bf16 first layers over 4 k steps run in
    the workspace instantiations only: such a game never plans level 0,
    not even without a net or when a level is forced below 1."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    assert grid2p._wide(game, net, dtype == torch.bfloat16) == wide
    if not wide:
        return
    for n in (net, None) if dtype == torch.float32 else (net,):
        assert grid2p.needs_workspace(game, _params(True), n, dtype)
        lb = grid2p.choose_lane_block(game, _params(True), n, dtype, 1024)
        assert grid2p.kernel_plan(game, _params(True), n, dtype, 1024,
                                  lb).workspace >= 1
    # Forced to level 0, the plan tries level 1 (which no such game fits).
    with grid2p._force_workspace(0):
        with pytest.raises(ValueError, match="workspace's level 1,"):
            grid2p.kernel_plan(game, _params(True), net, dtype, 1024, 1)


def test_frontier_solver_records_no_layout_on_the_cpu():
    """The evaluation's provenance: the kernel engine keeps its lane block
    and layout on the card, None for both on the CPU."""
    from rebel_tpu_torch.eval.recursive import Grid2FrontierSolver

    game = LiarsDice(2, 6)
    fs = Grid2FrontierSolver(game, _params(True), torch.float32, None,
                             engine="kernel", net=_net(game), device="cpu")
    assert (fs.lane_block_used, fs.layout_used) == (None, None)


# The workspace games' plans: every game, CFR and FP, bf16 and f32, 256x2
# net, B=1024.
WS_GAMES = [(2, 5), (3, 3), (2, 6), (3, 4), (1, 16)]


@pytest.mark.parametrize("dice,faces", WS_GAMES)
@pytest.mark.parametrize("use_cfr", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_workspace_plans_take_the_smallest_block(dice, faces, use_cfr,
                                                 dtype):
    """``choose_lane_block`` at a workspace game, worked out again from
    ``smem_layout``: the first layout (levels shallowest first, resident
    weights before the ring) at which the smallest lane block fits, and
    that block (2 for the two-group kernel, where it fits at all)."""
    game = LiarsDice(dice, faces)
    net, sub = _net(game), _params(use_cfr)
    bf16 = dtype == torch.bfloat16
    groups = [1, 2] if use_cfr and bf16 else [1]
    for il in groups:
        want = next(((il, ring, level) for ring, level
                     in grid2p._layouts(game, sub, net, dtype, il)
                     if grid2p.smem_layout(
                         game, il, use_cfr, 256, 2, bf16, il, False, ring,
                         level)["total"] <= grid2p.SMEM_LIMIT), None)
        if want is None:  # the two-group kernel at 3x4f: no block fits
            assert (dice, faces, il) == (3, 4, 2)
            with pytest.raises(ValueError, match="use a smaller lane_block"):
                grid2p.choose_lane_block(game, sub, net, dtype, 1024,
                                         interleave=il)
            continue
        assert want[2] >= 1  # no block of these games fits without
        lb = grid2p.choose_lane_block(game, sub, net, dtype, 1024,
                                      interleave=il)
        plan = grid2p.kernel_plan(game, sub, net, dtype, 1024, lb,
                                  interleave=il)
        assert (lb, plan.ring, plan.workspace) == want
        assert plan.groups == il


@pytest.mark.parametrize("num_actions", [9, 13, 19, 25, 33, 64])
def test_level1_cells_are_kept_once_row_by_row(num_actions):
    """``level1_cell`` (the kernel's ``row1`` in the workspace): the cells
    a2 > a1 take 0 .. level1_cells(A) - 1 once each, row by row, a2
    fastest; a cell a2 <= a1 has no place."""
    A = num_actions
    cells = [grid2p.level1_cell(A, a1, a2) for a1 in range(A)
             for a2 in range(a1 + 1, A)]
    assert cells == list(range(grid2p.level1_cells(A)))
    for a1, a2 in ((0, 0), (3, 2), (A - 1, A - 1)):
        with pytest.raises(ValueError, match="a2 > a1"):
            grid2p.level1_cell(A, a1, a2)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("items,hands", [(1, 33), (37, 36), (158, 36),
                                         (301, 36), (301, 64), (2408, 64),
                                         (211, 64)])
def test_reach_items_are_dealt_once_with_sums_in_order(items, hands, groups):
    """``deal_reach`` (rows wider than a warp): every (item, hand) value is
    computed once, by lane hand % 32; each batch's items (REACH_NB /
    groups) have their three sums (x0, x1, mass) taken by lanes 3 b + w
    alone, over the item's hands in index order; narrower rows take the
    other loops."""
    seen = []
    summed = {}
    dealt = grid2p.deal_reach(items, hands, groups)
    assert len(dealt) == grid2p.WARPS // groups
    for batches in dealt:
        for batch_items, values, sums in batches:
            assert len(batch_items) <= grid2p.REACH_NB // groups
            seen += [(e, h) for e, h, lane, j in values]
            assert all(h == lane + 32 * j for _, h, lane, j in values)
            for lane, e, row, order in sums:
                assert lane == 3 * batch_items.index(e) + row
                assert order == list(range(hands))
                summed[e, row] = summed.get((e, row), 0) + 1
    assert sorted(seen) == [(e, h) for e in range(items)
                            for h in range(hands)]
    assert summed == {(e, w): 1 for e in range(items) for w in range(3)}
    with pytest.raises(ValueError, match="33-128 hands, not 32"):
        grid2p.deal_reach(items, 32)


@pytest.mark.parametrize("A,H,lanes", [(9, 4, 8), (25, 36, 2), (25, 64, 1),
                                       (25, 64, 8), (13, 9, 16)])
def test_terminal_values_are_dealt_once_in_order(A, H, lanes):
    """``deal_terminal``: every challenge value (a1, lane, hand) and every
    lane's root-bid value (row A, lane, hand) is computed once, by one
    thread, its sum over the opponent's hands in index order."""
    got = [v for thread in grid2p.deal_terminal(A, H, lanes) for v in thread]
    assert sorted((row, lane, h) for row, lane, h, _ in got) == [
        (row, lane, h) for row in range(A + 1) for lane in range(lanes)
        for h in range(H)]
    assert all(order == list(range(H)) for *_, order in got)
