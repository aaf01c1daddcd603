"""Value-net query (de)serialization on the host, the counterpart of
``rebel_tpu/solving/queries.py``.

A query is the training interchange format:

    [ node_player, traverser, one_hot(last_bid) over num_actions,
      normalize_safe(reach_player0), normalize_safe(reach_player1) ]

of size ``2 + num_actions + 2 * num_hands``.  A terminal state is never
queried (the one-hot is never the liar call).  The tensor encoder of the
solvers is :func:`rebel_tpu_torch.solving.core.root_query`.
"""

from __future__ import annotations

import numpy as np

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving.core import REACH_EPS_F64


def get_query(game: LiarsDice, traverser: int, last_bid: int, player_id: int,
              reaches1, reaches2, eps: float = REACH_EPS_F64) -> np.ndarray:
    """The float32 query of one public state, normalised in float64."""
    if last_bid == game.liar_call:
        raise ValueError("a terminal state (a liar call) is never queried")
    r1 = np.asarray(reaches1, np.float64) + eps
    r2 = np.asarray(reaches2, np.float64) + eps
    onehot = (np.arange(game.num_actions) == last_bid).astype(np.float64)
    return np.concatenate(
        [[float(player_id), float(traverser)], onehot, r1 / r1.sum(),
         r2 / r2.sum()]
    ).astype(np.float32)


def deserialize_query(game: LiarsDice, query):
    """Inverse of :func:`get_query`: ``(traverser, last_bid, player_id,
    beliefs0, beliefs1)``; ``last_bid`` is -1 for the initial state."""
    q = np.asarray(query, np.float64)
    A, H = game.num_actions, game.num_hands
    player_id = int(q[0] + 0.5)
    traverser = int(q[1] + 0.5)
    last_bid = -1
    for a in range(A):
        if q[2 + a] > 0.5:
            last_bid = a
    beliefs0 = q[2 + A:2 + A + H].copy()
    beliefs1 = q[2 + A + H:2 + A + 2 * H].copy()
    return traverser, last_bid, player_id, beliefs0, beliefs1
