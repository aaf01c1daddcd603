"""Public game trees as structure-of-arrays tables (numpy only).

The port's own copy of ``rebel_tpu/tree.py``.  The unrolled tree is a set
of small dense integer tables (parent pointers, per-action child indices,
masks, per-depth level slices), so reach propagation and value backup are
per-level gathers over ``[num_nodes, num_hands, num_actions]`` tensors.

Two functions build trees:

* :func:`unroll_tree`: the concrete BFS tree from a given root public
  state, with the BFS-prefix property (a depth-``d`` unroll is a prefix of
  a deeper one).
* :func:`build_supertree`: a *virtual-root* tree whose level-1 children
  cover **all** actions.  A subgame rooted at any concrete public state is
  a runtime *mask* over this one static topology (see
  :func:`root_action_mask`), which lets many subgames with different roots
  be solved in lockstep.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from rebel_tpu_torch.games.liars_dice import INITIAL_ACTION, LiarsDice

# Sentinel child index for "no child via this action".
NO_CHILD = -1
# last_bid marker for the virtual root of a supertree.
VIRTUAL_ROOT_BID = -2


@dataclasses.dataclass(frozen=True, eq=False)
class TreeSpec:
    """Immutable structure-of-arrays public tree.  All arrays are host
    numpy; a solver context moves the index tables to its device."""

    game: LiarsDice
    # Root public state; for a supertree root_bid is VIRTUAL_ROOT_BID and
    # root_player is 0 (actual root context supplied at runtime).
    root_bid: int
    root_player: int
    max_depth: int

    parent: np.ndarray  # [N] i32, -1 at root
    depth: np.ndarray  # [N] i32
    last_bid: np.ndarray  # [N] i32, bid on the edge into the node
    first_action: np.ndarray  # [N] i32, lo of the node's bid range
    num_children: np.ndarray  # [N] i32
    children_begin: np.ndarray  # [N] i32 (BFS layout, contiguous children)
    child_index: np.ndarray  # [N, A] i32, NO_CHILD where invalid
    action_mask: np.ndarray  # [N, A] bool, legal actions at interior nodes
    is_terminal: np.ndarray  # [N] bool (liar-call nodes)
    is_leaf: np.ndarray  # [N] bool (no children in this unroll)
    challenged_bid: np.ndarray  # [N] i32, last_bid of parent (terminal payoff)
    anc1_action: np.ndarray  # [N] i32, first action on root->node path

    @property
    def num_nodes(self) -> int:
        return int(self.parent.shape[0])

    @functools.cached_property
    def level_slices(self) -> tuple[tuple[int, int], ...]:
        """Per-depth contiguous [start, end) node ranges (BFS order)."""
        slices = []
        d_max = int(self.depth.max())
        for d in range(d_max + 1):
            ids = np.nonzero(self.depth == d)[0]
            assert ids.size > 0 and ids[-1] - ids[0] + 1 == ids.size
            slices.append((int(ids[0]), int(ids[-1]) + 1))
        return tuple(slices)

    @functools.cached_property
    def terminal_ids(self) -> np.ndarray:
        return np.nonzero(self.is_terminal)[0].astype(np.int32)

    @functools.cached_property
    def pseudo_leaf_ids(self) -> np.ndarray:
        """Non-terminal leaves: nodes that need a value-net evaluation."""
        return np.nonzero(self.is_leaf & ~self.is_terminal)[0].astype(np.int32)

    @property
    def is_supertree(self) -> bool:
        return self.root_bid == VIRTUAL_ROOT_BID

    def node_player(self, node_id: int, root_player: int | None = None) -> int:
        """Actor at a node: players alternate from the root."""
        rp = self.root_player if root_player is None else root_player
        return (rp + int(self.depth[node_id])) % 2

    def children(self, node_id: int) -> list[int]:
        b = int(self.children_begin[node_id])
        return list(range(b, b + int(self.num_children[node_id])))


def _bfs_build(
    game: LiarsDice,
    root_bid: int,
    root_player: int,
    max_depth: int,
    root_children_range,
) -> TreeSpec:
    """BFS unroll shared by both functions: children of the frontier are
    appended in action order, so each depth level is a contiguous index
    range and shallower unrolls are prefixes of deeper ones."""
    A = game.num_actions
    # Per-node record lists, extended in BFS order.
    parent, depth, last_bid = [-1], [0], [root_bid]
    node_range = [root_children_range]
    children_begin, num_children = [0], [0]

    node_id = 0
    while node_id < len(parent):
        expandable = depth[node_id] < max_depth and not game.is_terminal(
            last_bid[node_id]
        )
        if expandable:
            lo, hi = node_range[node_id]
            children_begin[node_id] = len(parent)
            num_children[node_id] = hi - lo
            for a in range(lo, hi):
                parent.append(node_id)
                depth.append(depth[node_id] + 1)
                last_bid.append(a)
                node_range.append(game.bid_range(a))
                children_begin.append(0)
                num_children.append(0)
        node_id += 1

    N = len(parent)
    parent = np.asarray(parent, np.int32)
    depth = np.asarray(depth, np.int32)
    last_bid = np.asarray(last_bid, np.int32)
    children_begin = np.asarray(children_begin, np.int32)
    num_children = np.asarray(num_children, np.int32)

    first_action = np.asarray([r[0] for r in node_range], np.int32)
    child_index = np.full((N, A), NO_CHILD, np.int32)
    action_mask = np.zeros((N, A), bool)
    for n in range(N):
        k = num_children[n]
        if k:
            lo = first_action[n]
            child_index[n, lo : lo + k] = np.arange(
                children_begin[n], children_begin[n] + k, dtype=np.int32
            )
            action_mask[n, lo : lo + k] = True

    is_terminal = (last_bid == game.liar_call) & (depth > 0)
    is_leaf = num_children == 0
    challenged_bid = np.where(parent >= 0, last_bid[np.maximum(parent, 0)], -1)
    anc1_action = np.zeros(N, np.int32)
    for n in range(1, N):
        anc1_action[n] = last_bid[n] if parent[n] == 0 else anc1_action[parent[n]]

    return TreeSpec(
        game=game,
        root_bid=root_bid,
        root_player=root_player,
        max_depth=max_depth,
        parent=parent,
        depth=depth,
        last_bid=last_bid,
        first_action=first_action,
        num_children=num_children,
        children_begin=children_begin,
        child_index=child_index,
        action_mask=action_mask,
        is_terminal=is_terminal,
        is_leaf=is_leaf,
        challenged_bid=challenged_bid.astype(np.int32),
        anc1_action=anc1_action,
    )


def unroll_tree(
    game: LiarsDice,
    root_bid: int = INITIAL_ACTION,
    root_player: int = 0,
    max_depth: int | None = None,
) -> TreeSpec:
    """Concrete BFS tree from a real public state.

    ``max_depth=0`` yields only the root; ``None`` unrolls the full game.
    """
    if max_depth is None:
        max_depth = game.max_depth
    assert max_depth >= 0
    return _bfs_build(
        game, root_bid, root_player, max_depth, game.bid_range(root_bid)
    )


def build_supertree(game: LiarsDice, max_depth: int | None = None) -> TreeSpec:
    """Virtual-root tree covering subgames rooted at *any* public state.

    The virtual root's children span all ``num_actions`` actions (including
    the liar call).  A concrete root with last bid ``b`` corresponds to the
    runtime level-1 mask :func:`root_action_mask`; everything below level 1
    has static topology because the bid range depends only on the node's own
    last bid, so one static topology serves every subgame of a batch.
    """
    if max_depth is None:
        max_depth = game.max_depth
    return _bfs_build(game, VIRTUAL_ROOT_BID, 0, max_depth, (0, game.num_actions))


def root_action_mask(game: LiarsDice, root_bid) -> np.ndarray:
    """``[..., A]`` legal level-1 actions of a supertree for concrete root
    bids ``root_bid [...]`` (ints or a numpy array): the opening move (bid
    ``INITIAL_ACTION``) may not call liar; otherwise actions are
    ``(root_bid, num_actions)``.  The tensor version is
    :func:`rebel_tpu_torch.solving.core.root_action_mask`."""
    b = np.asarray(root_bid)[..., None]
    a = np.arange(game.num_actions)
    return (a > b) & ((b != INITIAL_ACTION) | (a != game.liar_call))
