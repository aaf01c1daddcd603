"""Strategy printing, the counterpart of ``rebel_tpu/solving/printing.py``
(the reference's ``print_strategy``): one line per interior node with
every hand's action distribution at two decimal places, the same text as
the JAX package's."""

from __future__ import annotations

import sys

import numpy as np

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.tree import TreeSpec


def print_strategy(game: LiarsDice, tree: TreeSpec, strategy,
                   stream=None) -> None:
    """``strategy [nodes, hands, actions]`` (a tensor or an array) to
    ``stream`` (default: standard output)."""
    out = stream or sys.stdout
    s = np.asarray(strategy.cpu() if hasattr(strategy, "cpu") else strategy)
    assert s.shape[0] == tree.num_nodes
    out.write("Printing strategies per node\n")
    for node_id in range(tree.num_nodes):
        if tree.num_children[node_id] == 0:
            continue
        state = game.state_to_string(int(tree.last_bid[node_id]),
                                     tree.node_player(node_id))
        out.write(f"Node={node_id}\t{state}")
        for hand in range(s.shape[1]):
            out.write(f"| hand={hand} ")
            out.write(" ".join(f"{v:.2f}" for v in s[node_id][hand]) + " ")
        out.write("\n")


def print_strategy_to_file(game: LiarsDice, tree: TreeSpec, strategy,
                           path) -> None:
    with open(path, "w") as f:
        print_strategy(game, tree, strategy, f)
