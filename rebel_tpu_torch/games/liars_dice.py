"""Liar's Dice game descriptor (numpy tables).

The port's own copy of ``rebel_tpu/games/liars_dice.py``: the rules are
precomputed into small dense tables (match counts, terminal payoffs) that
the solvers read as device constants.

Rules (2-player Liar's Dice):
  * Each player privately rolls ``num_dice`` dice with ``num_faces`` faces.
  * Actions are bids ``(quantity, face)`` packed as
    ``action = (quantity - 1) * num_faces + face`` plus a final "liar" call
    (action id ``num_actions - 1``).
  * Bids must strictly increase in packed order; "liar" is allowed after
    any bid (but not as the opening action).
  * The highest face is wild: it matches every face.
  * After a "liar" call the game ends: the bid ``(q, f)`` is valid iff the
    number of dice matching ``f`` (or wild) across both hands is at least
    ``q``; the liar-caller loses iff the bid was valid.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Action encoding for "no bid yet" (root of the full game).
INITIAL_ACTION = -1


@dataclasses.dataclass(frozen=True)
class LiarsDice:
    num_dice: int
    num_faces: int

    @property
    def total_num_dice(self) -> int:
        return 2 * self.num_dice

    @property
    def num_actions(self) -> int:
        return 1 + self.total_num_dice * self.num_faces

    @property
    def num_hands(self) -> int:
        return self.num_faces**self.num_dice

    @property
    def liar_call(self) -> int:
        return self.num_actions - 1

    @property
    def wild_face(self) -> int:
        return self.num_faces - 1

    @property
    def query_size(self) -> int:
        """Value-net query width: player, traverser, one-hot last bid and
        both players' beliefs."""
        return 2 + self.num_actions + 2 * self.num_hands

    @property
    def max_depth(self) -> int:
        """Upper bound on the depth of the game tree."""
        return 1 + self.num_actions

    def unpack_action(self, action: int) -> tuple[int, int]:
        """(quantity, face) of a bid action."""
        assert 0 <= action < self.liar_call
        return 1 + action // self.num_faces, action % self.num_faces

    def bid_range(self, last_bid: int) -> tuple[int, int]:
        """Legal actions as ``[lo, hi)`` after ``last_bid``: the opening
        move may not be a liar call, any later move may."""
        if last_bid == INITIAL_ACTION:
            return 0, self.num_actions - 1
        return last_bid + 1, self.num_actions

    def is_terminal(self, last_bid: int) -> bool:
        return last_bid == self.liar_call

    def action_to_string(self, action: int) -> str:
        if action == INITIAL_ACTION:
            return "(initial)"
        if action == self.liar_call:
            return "liar"
        q, f = self.unpack_action(action)
        return f"bid(quantity={q},face={f})"

    def state_to_string(self, last_bid: int, player_id: int) -> str:
        return f"(pid={player_id},last={self.action_to_string(last_bid)})"

    def hand_to_dice(self, hand: int) -> list[int]:
        dice = []
        h = hand
        for _ in range(self.num_dice):
            dice.append(h % self.num_faces)
            h //= self.num_faces
        return dice

    @functools.cached_property
    def matches_table(self) -> np.ndarray:
        """``[num_hands, num_faces]``: dice in hand matching face-or-wild."""
        out = np.zeros((self.num_hands, self.num_faces), dtype=np.int32)
        for hand in range(self.num_hands):
            dice = self.hand_to_dice(hand)
            for f in range(self.num_faces):
                out[hand, f] = sum(
                    1 for d in dice if d == f or d == self.wild_face
                )
        return out

    @functools.cached_property
    def terminal_payoff(self) -> np.ndarray:
        """``[num_actions - 1, num_hands, num_hands]``: ``+1`` where bid
        ``(q, f)`` is valid when the bidder holds ``h`` and the challenger
        ``o`` (the bidder wins), else ``-1``."""
        A, H = self.num_actions, self.num_hands
        payoff = np.zeros((A - 1, H, H), dtype=np.float64)
        m = self.matches_table
        for bid in range(A - 1):
            q, f = self.unpack_action(bid)
            valid = (m[:, f][:, None] + m[:, f][None, :]) >= q
            payoff[bid] = np.where(valid, 1.0, -1.0)
        return payoff
