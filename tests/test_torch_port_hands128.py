"""The fused solve at the games of 65-128 hands (4x3f, 2x9f, 2x10f).

``kernels/grid2_cfr.cu`` takes every game of at most 128 hands and 64
actions (queries of at most 256 values) in its one-group workspace
instantiations: the reach rows of more than 64 hands are dealt four values
a lane, one item a warp, and with bf16 operands at 2x9f and 2x10f the head
stays in device memory (the workspace's level 5).  The
kernel runs on the card only (``chip_smoke.py large-games``,
``run-entry-4x3``); here, on the CPU:

* ``grid2p.solve_reference``, the kernel's yardstick on the card, against
  the JAX package's ``Grid2PallasSolver`` in interpret mode at 4x3f, 2x9f
  and 2x10f, CFR and FP, with a narrow net (16 wide, one hidden layer), on
  2 lanes over 4 iterations at atol 1e-5;
* the slice as a whole: ``grid2p.solve`` and ``advance`` for two steps at
  4x3f against ``FastPallasEngine`` with its draws injected;
* the plan: the three games take the workspace within the shared-memory
  limit at the smallest lane block, every game that launched
  before keeps its plan, and ``interleave=2`` at these games is refused
  before anything is built (the games over the limits:
  ``test_torch_port_large_games.py``);
* ``grid2p.deal_reach`` and ``deal_terminal`` (the kernel's dealing of the
  rows) at 65-128 hands (``deal_wide``: ``test_torch_port_large_games.py``).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_port_hands128.py -q`` (some three minutes, most of it the
JAX package's interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.selfplay.fast_runner import FastPallasEngine
from rebel_tpu.selfplay.runner import EpisodeState as JEpisodeState
from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRSP
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.selfplay.fast_runner import advance
from rebel_tpu_torch.selfplay.runner import EpisodeState, RecursiveSolvingParams
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from test_torch_port_large_games import KEPT, TAKEN, _jax_draws

LANES = 2
ITERS = 4
GAMES = [(4, 3), (2, 9), (2, 10)]


def _inputs(game, seed):
    """Roots at the initial bid and the last bid before the liar call,
    both players, Dirichlet beliefs, stop iterations at both ends."""
    rng = np.random.RandomState(seed)
    bids = np.array([-1, game.num_actions - 2], np.int32)
    players = np.array([1, 0], np.int32)
    beliefs = rng.dirichlet(np.ones(game.num_hands), size=(LANES, 2)).astype(
        np.float32)
    t_stop = np.array([ITERS, rng.randint(1, ITERS)], np.int32)
    return bids, players, beliefs, t_stop


def _narrow_net(dice, faces, seed):
    """A 16x1 LayerNorm net from ``PRNGKey(seed)``: the JAX package's
    parameters and the port's CFVNet carried over by ``from_flax``."""
    spec = CFVNetSpec(game=JLiarsDice(dice, faces), n_hidden=16, n_layers=1,
                      use_layer_norm=True)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          spec.init_params(jax.random.PRNGKey(seed)))
    return params, net_from_state_dict(from_flax(params),
                                       LiarsDice(dice, faces))


@pytest.mark.parametrize("dice,faces,solver",
                         [(*g, s) for g in GAMES for s in ("cfr", "fp")])
def test_solve_reference_matches_pallas_at_hands128(dice, faces, solver):
    game = LiarsDice(dice, faces)
    assert grid2p.MAX_ROW < game.num_hands <= grid2p.MAX_HANDS
    kw = dict(num_iters=ITERS, max_depth=2, use_cfr=solver == "cfr",
              linear_update=True)
    bids, players, beliefs, t_stop = _inputs(game, 10 * dice + faces)
    params_j, net = _narrow_net(dice, faces, 3)
    ref = Grid2PallasSolver(
        game=JLiarsDice(dice, faces), params=JParams(**kw), lane_block=LANES,
        interpret=True,
    ).solve(bids, players, beliefs, t_stop, params_j)
    out = grid2p.solve_reference(
        game, SubgameSolvingParams(**kw), torch.as_tensor(bids),
        torch.as_tensor(players), torch.as_tensor(beliefs),
        torch.as_tensor(t_stop), net)
    for name in ("rvm", "snap0", "snap1"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)


# ------------------------------------------------------ the whole slice

SUB = dict(num_iters=4, max_depth=2, linear_update=True, use_cfr=True)
B = 2


def test_engine_step_matches_pallas_engine_at_4x3():
    """Two self-play steps at 4x3f (81 hands: a query of 189 values): the
    port's solve and walk with the JAX engine's draws injected give its
    values, queries and next roots at the JAX package's tolerances (values
    2e-5, queries 1e-6)."""
    jcfg = JRSP(num_dice=4, num_faces=3, subgame_params=JParams(**SUB),
                random_action_prob=0.25, sample_leaf=True)
    cfg = RecursiveSolvingParams(
        num_dice=4, num_faces=3, subgame_params=SubgameSolvingParams(**SUB),
        random_action_prob=0.25, sample_leaf=True)
    game = cfg.game
    params, net = _narrow_net(4, 3, 43)
    jeng = FastPallasEngine(cfg=jcfg, dtype=jnp.float32, lane_block=B,
                            interpret=True)
    ep_j = JEpisodeState.initial_batch(jcfg.game, B, jnp.float32)
    for step in range(2):
        keys = jax.random.split(jax.random.PRNGKey(430 + step), B)
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


def _net(game):
    return CFVNet(game, 256, 2, True,
                  generator=torch.Generator().manual_seed(0))


# 256x2 net, B=1024: (lane block, layout) for bf16 and f32, CFR and FP
# alike.
TAKEN128 = {(4, 3): ((1, "ring+workspace4"), (1, "resident+workspace5")),
            (2, 9): ((1, "ring+workspace5"), (1, "resident+workspace5")),
            (2, 10): ((1, "ring+workspace5"), (1, "resident+workspace5"))}


@pytest.mark.parametrize("dice,faces", list(TAKEN128))
def test_hands128_games_take_the_workspace(dice, faces):
    """Each takes the workspace's shallowest level at which a block fits,
    at the smallest lane block, within the shared-memory limit, with the
    bytes ``smem_layout`` reports; the level below fits no lane block.
    bf16 keeps the head in device memory at level 5, and the reach rows of
    one item a warp (four values a lane)."""
    game = LiarsDice(dice, faces)
    H, hn = game.num_hands, -(-game.num_hands // 8) * 8
    net = _net(game)
    for use_cfr in (True, False):
        sub = _params(use_cfr)
        for dtype, want in zip((torch.bfloat16, torch.float32),
                               TAKEN128[dice, faces]):
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
            if bf16:
                at5 = grid2p.smem_layout(game, 1, use_cfr, 256, 2, True,
                                         ring=True, workspace=grid2p.WS_HEAD)
                at4 = grid2p.smem_layout(game, 1, use_cfr, 256, 2, True,
                                         ring=True, workspace=grid2p.WS_BODY)
                assert at4["mlp"] - at5["mlp"] == 2 * hn * 256
                assert got["scratch"] == 4 * (
                    grid2p.WARPS * 3 * (H | 1) + grid2p.WS_BODY_WORDS)


@pytest.mark.parametrize("dice,faces", list(KEPT) + list(TAKEN))
def test_games_of_up_to_64_hands_keep_their_plan(dice, faces):
    """Every game that launched before takes the lane block and layout it
    took: the new level and the reach rows of four values a lane are
    for rows over 64 hands only."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    want = (KEPT.get((dice, faces)) or TAKEN[dice, faces])
    for use_cfr in (True, False):
        for dtype, plan_want in zip((torch.bfloat16, torch.float32), want):
            if plan_want is None:
                continue
            lb = grid2p.choose_lane_block(game, _params(use_cfr), net, dtype,
                                          1024)
            plan = grid2p.kernel_plan(game, _params(use_cfr), net, dtype,
                                      1024, lb)
            assert (lb, plan.layout) == plan_want


@pytest.mark.parametrize("dice,faces", list(TAKEN128))
def test_interleave2_is_refused_over_64_hands(dice, faces):
    """``interleave=2`` runs two groups of warps, whose reach rows hold two
    values a lane: refused by name before anything is built."""
    game = LiarsDice(dice, faces)
    net = _net(game)
    with pytest.raises(ValueError, match="Queue 6 item 8"):
        grid2p.choose_lane_block(game, _params(True), net, torch.bfloat16,
                                 1024, interleave=2)
    with pytest.raises(ValueError, match="at most 64 hands, not"):
        grid2p.kernel_plan(game, _params(True), net, torch.float32, 1024, 2,
                           interleave=2)
    # FP runs as interleave=1.
    assert grid2p.kernel_plan(game, _params(False), net, torch.bfloat16,
                              1024, 1, interleave=2).groups == 1


# ---------------------------------------------------------- the dealing


@pytest.mark.parametrize("items,hands", [(301, 81), (37, 100), (5, 128)])
def test_reach_rows_over_64_hands_are_dealt_once(items, hands):
    """``deal_reach`` at 81, 100 and 128 hands: one item a warp at a time,
    every (item, hand) value computed once by lane
    hand % 32 in register hand // 32, each item's three sums by lanes
    3 b + w alone over its hands in index order; two groups of warps take
    no such row."""
    assert grid2p.reach_nb(hands) == 1
    seen, summed = [], {}
    for batches in grid2p.deal_reach(items, hands):
        for batch_items, values, sums in batches:
            assert len(batch_items) == 1
            seen += [(e, h) for e, h, lane, j in values]
            assert all(h == lane + 32 * j for _, h, lane, j in values)
            for lane, e, row, order in sums:
                assert lane == 3 * batch_items.index(e) + row
                assert order == list(range(hands))
                summed[e, row] = summed.get((e, row), 0) + 1
    assert sorted(seen) == [(e, h) for e in range(items)
                            for h in range(hands)]
    assert summed == {(e, w): 1 for e in range(items) for w in range(3)}
    with pytest.raises(ValueError, match="33-64 hands"):
        grid2p.deal_reach(items, hands, groups=2)


def test_terminal_values_over_64_hands_are_dealt_once():
    """``deal_terminal`` at (25, 81, 1): every challenge value and the
    root bid's value of each hand computed once, its sum over the 81
    opponent hands in index order."""
    A, H, lanes = 25, 81, 1
    got = [v for thread in grid2p.deal_terminal(A, H, lanes) for v in thread]
    assert sorted((row, lane, h) for row, lane, h, _ in got) == [
        (row, lane, h) for row in range(A + 1) for lane in range(lanes)
        for h in range(H)]
    assert all(order == list(range(H)) for *_, order in got)
