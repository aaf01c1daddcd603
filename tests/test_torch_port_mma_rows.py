"""The fused solve's tensor-core MLP at the larger games: what the CPU
reaches of its planning.

``smem_layout`` mirrors the kernel's shared memory, here held to the byte
counts the layout's trim was reckoned from; ``choose_lane_block`` and
``kernel_plan`` pick and check the lane block from it; ``deal_rows``
mirrors the kernel's dealing of query rows to warps.  The kernel itself
runs on the card only: ``chip_smoke.py`` holds its lane blocks to the
same bits (``games``) and a chunk of one real row a warp to the default's
(``knob-checks``), and ``chip_studies.py same-bits`` holds it to the
version before.
"""

import math

import numpy as np
import pytest
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

LIMIT = grid2p.SMEM_LIMIT  # 232,448 B a block on sm_90


def _params(use_cfr, optimistic=False):
    return SubgameSolvingParams(num_iters=8, max_depth=2, use_cfr=use_cfr,
                                linear_update=True, optimistic=optimistic)


def _net(game):
    return CFVNet(game, 256, 2, True,
                  generator=torch.Generator().manual_seed(0))


def _trimmed(game, lane_block, use_cfr):
    """Bytes the layout no longer keeps with a net: the leaf values and
    the level-1 values (they share the staging rows), and FP's last best
    response (read only when optimistic)."""
    A, H = game.num_actions, game.num_hands
    P = len(grid2p.pseudo_leaf_pairs(game))
    words = lambda n: -(-n // 4) * 4
    lb = lane_block
    gone = words(P * lb * H) + words(lb * A * H)
    if not use_cfr:
        gone += words(lb * H * A) + words(lb * A * H * A)
    return 4 * gone


@pytest.mark.parametrize(
    "game,lane_block,use_cfr,before",
    # One block's bytes before the trim (the kernel's figures at ce287e5):
    # 2x3f FP at lane block 2 was 1,312 B over the limit, 2x3f CFR at 4
    # and 1x6f FP at 4 did not fit.
    [((2, 3), 2, False, 233760), ((2, 3), 4, True, 265536),
     ((1, 6), 4, False, 238480), ((1, 4), 8, True, 198688),
     ((1, 4), 8, False, 210208)])
def test_one_block_layout_after_the_trim(game, lane_block, use_cfr, before):
    g = LiarsDice(*game)
    got = grid2p.smem_layout(g, lane_block, use_cfr, 256, 2, True)
    assert got["total"] == before - _trimmed(g, lane_block, use_cfr)
    # The packed block is resident whole: 170,064 B at 2x3f (H = 9), and
    # 157,744 B at 1x4f to 1x6f, its barrier included.
    assert got["mlp"] == (170064 if game == (2, 3) else 157744)
    # FP's last response comes back with the optimistic variant.
    if not use_cfr:
        opt = grid2p.smem_layout(g, lane_block, False, 256, 2, True,
                                 optimistic=True)
        A, H = g.num_actions, g.num_hands
        words = lambda n: -(-n // 4) * 4
        assert opt["lanes"] - got["lanes"] == 4 * (
            words(lane_block * H * A) + words(lane_block * A * H * A))


def test_two_by_three_fp_fits_lane_block_two_in_one_block():
    got = grid2p.smem_layout(LiarsDice(2, 3), 2, False, 256, 2, True)
    assert got["total"] == 214944 <= LIMIT


# The lane block chosen at 1024 lanes, bf16, CFR and FP: the largest one
# block holds with the weights resident (256x2), and with the bf16 ring
# where none holds them (256x3).
CHOSEN = {(1, 4): 8, (1, 5): 8, (1, 6): 4, (2, 3): 2}
CHOSEN_RING = {(1, 4): 8, (1, 5): 8, (1, 6): 8, (2, 3): 4}


@pytest.mark.parametrize("use_cfr", [True, False])
@pytest.mark.parametrize("dice,faces", list(CHOSEN))
def test_choice_of_lane_block(dice, faces, use_cfr):
    game = LiarsDice(dice, faces)
    net = _net(game)
    lb = grid2p.choose_lane_block(game, _params(use_cfr), net,
                                  torch.bfloat16, 1024)
    assert lb == CHOSEN[dice, faces]
    plan = grid2p.kernel_plan(game, _params(use_cfr), net, torch.bfloat16,
                              1024, lb)
    assert plan.smem == grid2p.smem_layout(game, lb, use_cfr, 256, 2,
                                           True)["total"] <= LIMIT
    assert not plan.ring
    if lb < 8:  # the next block streams the hidden layers instead
        assert grid2p.kernel_plan(game, _params(use_cfr), net,
                                  torch.bfloat16, 1024, 2 * lb).ring
    # A bf16 net of 3 hidden layers fits no lane block with its weights
    # resident: the choice takes the largest block the ring fits, and 2x3f
    # at lane block 8 does not fit even with the ring.
    deep = CFVNet(game, 256, 3, True,
                  generator=torch.Generator().manual_seed(0))
    lb = grid2p.choose_lane_block(game, _params(use_cfr), deep,
                                  torch.bfloat16, 1024)
    assert lb == CHOSEN_RING[dice, faces]
    assert grid2p.kernel_plan(game, _params(use_cfr), deep, torch.bfloat16,
                              1024, lb).ring
    if (dice, faces) == (2, 3):
        with pytest.raises(ValueError, match="lane_block 8 .* bf16 ring"):
            grid2p.kernel_plan(game, _params(use_cfr), net, torch.bfloat16,
                               1024, 8)


def test_optimistic_fp_keeps_its_last_response():
    """The optimistic FP keeps last0/last1: at 2x3f lane block 2 still
    fits with the weights resident, 4 only with the bf16 ring, 8 not
    at all."""
    game = LiarsDice(2, 3)
    params = _params(False, optimistic=True)
    net = _net(game)
    assert grid2p.choose_lane_block(game, params, net, torch.bfloat16,
                                    1024) == 2
    assert grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024,
                              4).ring
    with pytest.raises(ValueError, match="shared memory"):
        grid2p.kernel_plan(game, params, net, torch.bfloat16, 1024, 8)


# Rows of a chunk at the launches of the larger games: lane block x
# pairs.
@pytest.mark.parametrize("rows", [66, 132, 224, 264, 360, 528, 1056, 17, 1])
def test_rows_are_dealt_once_with_no_idle_turn(rows):
    turns = grid2p.deal_rows(rows)
    assert len(turns) == math.ceil(rows / 128)
    dealt = sorted(r for turn in turns for _, _, first, n in turn
                   for r in range(first, first + n))
    assert dealt == list(range(rows))  # every row once
    for turn in turns:
        # No warp works on padding alone, and every warp but the turn's
        # last has 16 real rows.
        assert all(n > 0 for *_, n in turn)
        assert sum(n < 16 for *_, n in turn) <= 1
        # Both warpgroups work whenever the turn has two groups of rows.
        if len(turn) >= 2:
            assert {g for g, *_ in turn} == {0, 1}
        # The live warps reach the four schedulers (warp w of either
        # warpgroup) as evenly as they can.
        per = np.bincount([w for _, w, *_ in turn], minlength=4)
        assert per.max() - per.min() <= 1


def test_row_dealing_of_the_warpgroups_table():
    """The filled share of the warpgroup turns at the old launches, and
    the turns of the new ones: (rows, turns, live warps)."""
    for rows, n_turns, warps in ((66, 1, 5), (132, 2, 9), (264, 3, 17),
                                 (224, 2, 14), (528, 5, 33)):
        turns = grid2p.deal_rows(rows)
        assert len(turns) == n_turns
        assert sum(len(t) for t in turns) == warps == math.ceil(rows / 16)
    # One warpgroup (the interleaved kernel's group): its four warps in
    # order.
    assert grid2p.deal_rows(40, warpgroups=1) == [
        [(0, 0, 0, 16), (0, 1, 16, 16), (0, 2, 32, 8)]]
