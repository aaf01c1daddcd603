"""The full-tree solve of the evaluation (phase 1 of ``run_eval``) at the
paper protocol's 1024 iterations on 1x4f, port against JAX package, on
the CPU in float32 and float64.

Fictitious play averages best responses and does not amplify rounding:
the two packages' exploitability trajectories agree at every power-of-two
iteration to 1e-6, in both dtypes.  CFR's iterates are chaotic: in
float64 the two agree to 1e-6 through iteration 128 and part ways after
it (another summation order in one dot product is enough), and in
float32 already by iteration 128; what stays is the order of magnitude at
1024 iterations.  The readings are printed (``pytest -s``); PERF.md
quotes them beside the JAX package's readings on a TPU.
"""

import jax.numpy as jnp
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.eval.recursive_eval import full_solve as jfull_solve
from rebel_tpu.solving.params import SubgameSolvingParams as JParams

from rebel_tpu_torch.eval.recursive_eval import full_solve
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving.params import SubgameSolvingParams

ITERS = 1024


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("solver", ["fp", "cfr"])
def test_full_tree_solve_1024_iterations(solver, dtype):
    kw = dict(num_iters=ITERS, max_depth=2, linear_update=True,
              use_cfr=solver == "cfr")
    _, traj, _ = full_solve(LiarsDice(1, 4), SubgameSolvingParams(**kw),
                            getattr(torch, dtype), progress=False,
                            device="cpu")
    _, jtraj, _ = jfull_solve(JLiarsDice(1, 4), JParams(**kw),
                              jnp.dtype(dtype), progress=False)
    assert [t["iter"] for t in traj] == [t["iter"] for t in jtraj]
    port = {t["iter"]: t["sum"] for t in traj}
    ref = {t["iter"]: t["sum"] for t in jtraj}
    print(f"\nfull tree 1x4f {solver} {dtype}: exploitability at "
          f"128/256/512/1024 iterations: port "
          f"{[round(port[i], 6) for i in (128, 256, 512, 1024)]}, JAX "
          f"package {[round(ref[i], 6) for i in (128, 256, 512, 1024)]}")
    if solver == "fp":
        agree_until = ITERS
    else:
        agree_until = 128 if dtype == "float64" else 8
    for it in port:
        if it <= agree_until:
            assert abs(port[it] - ref[it]) < 1e-6, (it, port[it], ref[it])
    # Both converge: within a factor of 4 of each other at the end, and
    # far below the exploitability at iteration 128.
    assert 0.25 < port[ITERS] / ref[ITERS] < 4.0
    assert port[ITERS] < 0.5 * port[128]
