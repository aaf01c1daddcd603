"""The plain version of the fused solve against the Pallas kernel at the
larger games.

On the card ``grid2p.solve_reference`` is the yardstick of the fused
kernel at every game (``chip_smoke.py`` holds the kernel to it at 1x5f,
1x6f and 2x3f).  Here it is held to the JAX package's
``Grid2PallasSolver`` in interpret mode at those games, CFR and FP, with
no net and with a narrow net (16 wide, one hidden layer), on 4 lanes over
8 iterations: at atol 1e-5 in f32, the tolerance of the 1x4f tests
(``test_torch_port_grid2.py``, ``test_torch_port_fp.py``) and of the JAX
package's own kernel against grid2b.  FP counts the lanes that differ and
allows none, as the 1x4f test does.
"""

import jax
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.solving.grid2p import Grid2PallasSolver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.solving import grid2p
from rebel_tpu_torch.solving.params import SubgameSolvingParams

LANES = 4
ITERS = 8
GAMES = [(1, 5), (1, 6), (2, 3)]


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


@pytest.mark.parametrize("net_mode", ["nonet", "16x1"])
@pytest.mark.parametrize("solver", ["cfr", "fp"])
@pytest.mark.parametrize("dice,faces", GAMES)
def test_solve_reference_matches_pallas_at_larger_games(dice, faces, solver,
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
