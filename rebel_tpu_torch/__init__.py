"""PyTorch/CUDA port of ``rebel_tpu`` for one NVIDIA H100.

The package keeps the layout and names of ``rebel_tpu`` so each module has
an obvious counterpart there.  It imports ``torch`` and numpy only; the
depth-2 subgame solve, CFR or fictitious play, runs as one hand-written
CUDA kernel (``kernels/grid2_cfr.cu``) on the card and as its plain
PyTorch version (``solving.grid2p.solve_reference``) on the CPU, in
self-play (``training.trainer``) and in evaluation
(``eval.recursive_eval``, ``python -m rebel_tpu_torch.eval.eval_all``).
"""

from rebel_tpu_torch.games.liars_dice import LiarsDice

__all__ = ["LiarsDice"]
