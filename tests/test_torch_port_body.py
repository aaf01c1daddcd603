"""The host-side reckoning of the fused solve's iteration body.

``kernels/grid2_cfr.cu`` deals every phase's items to its threads by a
work split that the wrapper fixes once per launch
(``grid2p.work_split``): a thread finds an item's row, lane and hand (or
its slot of H or A threads in a warp) from an index by a multiply and a
shift, not by a division.  The kernel runs on the card only; here the
multipliers must divide exactly every index the kernel meets, at every
game of ``eval_all``'s defaults and others, for every lane block the
wrapper may launch, and ``kernel_plan`` must refuse games whose rows do
not fit a warp two values a lane.  ``chip_studies.py same-bits``, which holds the body to
another version of the kernel bit for bit, refuses to run without a
card.
"""

import numpy as np
import pytest
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

GAMES = [(1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (2, 2), (2, 3), (2, 4)]


def _split(i: np.ndarray, mul: int) -> np.ndarray:
    """The kernel's split(): the high 32 bits of the 64-bit product."""
    return (i.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32)


@pytest.mark.parametrize("dice,faces", GAMES)
def test_work_split_divides_every_item_exactly(dice, faces):
    """For groups of 1 to 16 lanes: the reach phase's items (k, lane) of
    the P + A items a lane, the (row, lane, hand) items of the terminal
    (A + 1 rows) and level-1 (A rows) phases, the root rows (lane, hand),
    and a warp's slots of H and of A threads, as the kernel decodes
    them."""
    game = LiarsDice(dice, faces)
    A, H = game.num_actions, game.num_hands
    P = len(grid2p.pseudo_leaf_pairs(game))
    lanes_ = np.arange(32)
    for lanes in range(1, 17):
        mul_h, mul_a, mul_lb, mul_lbh = grid2p.work_split(game, lanes)
        e = np.arange(lanes * (P + A) + 32)  # past the end: idle slots
        if lanes > 1:
            np.testing.assert_array_equal(_split(e, mul_lb), e // lanes)
        else:
            assert mul_lb == 0
        i = np.arange((A + 1) * lanes * H)
        np.testing.assert_array_equal(_split(i, mul_lbh), i // (lanes * H))
        r = i % (lanes * H)
        np.testing.assert_array_equal(_split(r, mul_h), r // H)
        np.testing.assert_array_equal(_split(lanes_, mul_h), lanes_ // H)
        np.testing.assert_array_equal(_split(lanes_, mul_a), lanes_ // A)
        assert _split(np.array([32]), mul_h)[0] == 32 // H
        assert _split(np.array([32]), mul_a)[0] == 32 // A


def test_split_mul_holds_to_the_bound_it_states():
    """Exact for i d < 2^32, including the largest i of each range and the
    divisors that are powers of two (where the multiplier is 2^32 / d)."""
    for d in (2, 3, 4, 7, 8, 9, 13, 18, 32, 37, 80, 126, 169, 4095):
        mul = grid2p.split_mul(d)
        assert 2**32 / d <= mul < 2**32 / d + 1
        top = (2**32 - 1) // d
        i = np.array([0, 1, d - 1, d, d + 1, top - 1, top], np.uint64)
        np.testing.assert_array_equal(_split(i, mul), i // np.uint64(d))
    with pytest.raises(ValueError, match="2 or more"):
        grid2p.split_mul(1)


def test_one_short_multiplier_misdeals_a_lane_edge():
    """What the split-lane-edge mutant of chip_mutants.py does: a lane
    multiplier one short deals the first lane of every reach item but the
    first as lane LB of the item before, one past the group's lanes."""
    mul = grid2p.work_split(LiarsDice(1, 4), 8)[2] - 1
    e = np.arange(8 * 37)
    k = _split(e, mul)
    wrong = np.nonzero(k != e // 8)[0]
    np.testing.assert_array_equal(wrong, np.arange(1, 37) * 8)
    assert set((e - 8 * k)[wrong].tolist()) == {8}


def test_plan_refuses_rows_wider_than_a_warp():
    """Rows wider than a warp are dealt two values a lane up to 64 hands,
    four up to 128: 2x6f (36 hands) and 4x3f (81) launch, 5x3f (243) does
    not, whatever the lane block."""
    sub = SubgameSolvingParams(num_iters=4, max_depth=2, use_cfr=True)
    for game in (LiarsDice(2, 6), LiarsDice(4, 3)):
        plan = grid2p.kernel_plan(game, sub, None, torch.float32, 8, 1)
        assert plan.smem <= grid2p.SMEM_LIMIT
    for lane_block in (1, 8):
        with pytest.raises(ValueError, match="at most 128 hands, not 243"):
            grid2p.kernel_plan(LiarsDice(5, 3), sub, None, torch.float32, 8,
                               lane_block)


def test_same_bits_study_needs_the_card(tmp_path):
    """``python3 chip_studies.py same-bits`` launches two builds of the
    kernel on the card and refuses without one."""
    import importlib.util
    import pathlib

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_studies.py"
    spec = importlib.util.spec_from_file_location("chip_studies", path)
    studies = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(studies)
    with pytest.raises(SystemExit, match="card"):
        studies.main(["same-bits", "--old", str(tmp_path / "grid2_cfr.cu"),
                      "--out", str(tmp_path)])


@pytest.mark.parametrize("returncode,output,verdict", [
    (1, ["check cfr nonet: B=256 iters=4: max_abs_diff=1.1e+00 "
         "limit=1.0e-04 MISS", "chip_smoke: FAIL: kernel check cfr nonet"],
     "CAUGHT"),
    (1, ["check cfr nonet: B=256 iters=4: max_abs_diff=7.7e-07 "
         "limit=1.0e-04 ok", "torch.AcceleratorError: CUDA error: an "
         "illegal memory access was encountered"], "CAUGHT"),
    (1, ["grid2_cfr.cu(1210): error: identifier \"x\" is undefined",
         "chip_smoke: FAIL: kernel build"], "harness failed"),
    (1, ["Traceback (most recent call last):",
         "TypeError: expected all tensors on one device"], "harness failed"),
    (1, ["control cfr bf16: B=256 iters=4: kernel f32 vs plain bf16 "
         "max_abs_diff=1.0e-05, must exceed 1.0e-03 MISS"],
     "harness failed"),
    (0, ["check cfr nonet: B=256 iters=4: max_abs_diff=7.7e-07 "
         "limit=1.0e-04 ok"], "not caught"),
])
def test_mutant_verdicts(returncode, output, verdict):
    """``chip_mutants.py`` counts a mutant caught only on a check's MISS
    or a fault of the kernel on the card; a run that fails otherwise (a
    build error, a Python error, a control that does not separate) is
    the harness's failure, not a catch."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_mutants.py"
    spec = importlib.util.spec_from_file_location("chip_mutants", path)
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    got, lines = mutants.judge(returncode, output)
    assert got == verdict
    assert lines
