"""Self-play episode types (the subset of ``rebel_tpu/selfplay/runner.py``
the depth-2 engine uses).

An engine step advances ``B`` episodes ("lanes") in lockstep: each lane
solves the depth-2 subgame at its public state, samples the next state
from the policy at a random stop iteration, and emits two training
examples (one per traverser).  Lanes that reach a terminal state restart
from the initial state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice
from rebel_tpu_torch.solving.params import SubgameSolvingParams


@dataclasses.dataclass(frozen=True)
class RecursiveSolvingParams:
    num_dice: int = 1
    num_faces: int = 4
    subgame_params: SubgameSolvingParams = SubgameSolvingParams()
    random_action_prob: float = 1.0
    sample_leaf: bool = False

    @property
    def game(self) -> LiarsDice:
        return LiarsDice(self.num_dice, self.num_faces)


class EpisodeState(NamedTuple):
    """Per-lane public state and beliefs; lanes lead every tensor."""

    root_bid: torch.Tensor  # [B] int64, -1 = initial state
    root_player: torch.Tensor  # [B] int64
    beliefs: torch.Tensor  # [B, 2, H]

    @staticmethod
    def initial_batch(game: LiarsDice, batch: int, device="cuda",
                      dtype=torch.float32) -> "EpisodeState":
        return EpisodeState(
            root_bid=torch.full((batch,), INITIAL_ACTION, dtype=torch.long,
                                device=device),
            root_player=torch.zeros((batch,), dtype=torch.long,
                                    device=device),
            beliefs=torch.full((batch, 2, game.num_hands),
                               1.0 / game.num_hands, dtype=dtype,
                               device=device),
        )

    @staticmethod
    def initial(game: LiarsDice, device="cuda", dtype=torch.float32):
        """One lane's initial state (a batch of one)."""
        return EpisodeState.initial_batch(game, 1, device, dtype)


class StepOutput(NamedTuple):
    queries: torch.Tensor  # [B, 2, Q] training queries (traverser 0, 1)
    values: torch.Tensor  # [B, 2, H] root counterfactual values
    ended: torch.Tensor  # [B] bool: the episode ended this step
