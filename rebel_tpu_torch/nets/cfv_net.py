"""Counterfactual-value network in the reference ``Net2`` layout.

Input ``2 + num_actions + 2*num_hands`` -> ``n_layers`` x [Linear ->
LayerNorm (eps 1e-5) or empty -> GELU (exact erf) -> empty dropout slot]
of width ``n_hidden`` -> ``output`` Linear to ``num_hands`` whose weight
and bias are scaled by 0.01 at init, so first predictions are near zero.
The state-dict names (``body.{4k}``, ``body.{4k+1}``, ``output``) are the
reference checkpoints' own, so a state dict saved here loads there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rebel_tpu_torch.games.liars_dice import LiarsDice


class CFVNet(nn.Module):
    def __init__(self, game: LiarsDice, n_hidden: int = 256,
                 n_layers: int = 2, use_layer_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.game = game
        self.n_hidden = n_hidden
        self.n_layers = n_layers
        self.use_layer_norm = use_layer_norm
        layers: list[nn.Module] = []
        last = game.query_size
        for _ in range(n_layers):
            layers.append(nn.Linear(last, n_hidden))
            layers.append(
                nn.LayerNorm(n_hidden, eps=1e-5) if use_layer_norm
                else nn.Sequential()
            )
            layers.append(nn.GELU())  # exact erf form
            layers.append(nn.Sequential())  # dropout slot (always 0)
            last = n_hidden
        self.body = nn.Sequential(*layers)
        self.output = nn.Linear(last, game.num_hands)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None):
        """torch's default Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for weight and bias, drawn from ``generator`` (a CPU generator),
        with the head scaled by 0.01."""
        linears = [m for m in self.body if isinstance(m, nn.Linear)]
        for lin in linears + [self.output]:
            bound = 1.0 / math.sqrt(lin.in_features)
            for t in (lin.weight, lin.bias):
                u = torch.rand(t.shape, generator=generator)
                t.copy_((u * 2 - 1) * bound)
        self.output.weight.mul_(0.01)
        self.output.bias.mul_(0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.body(x))

    def hidden_layers(self):
        """``[(linear, layer_norm or None)]`` per hidden layer."""
        out = []
        for k in range(self.n_layers):
            ln = self.body[4 * k + 1]
            out.append((self.body[4 * k],
                        ln if isinstance(ln, nn.LayerNorm) else None))
        return out
