"""Rank programs that hold the port's SPMD path to a reference: a group
of ranks runs cases on given inputs and each rank saves what it got.
``tests/test_torch_port_spmd.py`` and ``chip_smoke.py``'s ``spmd`` phase
start the groups and compare.

    python spmd_parity.py INPUT OUTPUT --dist host:port,N,i [--device cpu]

``INPUT`` is a ``torch.save`` of ``{case: inputs}``; rank ``i`` saves
``{case: outputs}`` to ``OUTPUT.rank<i>.pt``.

Cases (:data:`CASES`):

* ``train_step``: :func:`~rebel_tpu_torch.parallel.mesh.make_spmd_programs`'
  ``train_step`` over given local rings with given sample slots; each rank
  saves its net after every step, the steps' statistics, and the
  relative difference between the averaged gradient and the gradient of
  one process on the batches of every rank put together;
* ``hands``: ``Grid2Solver.multistep`` and ``FastSelfPlayEngine.batch_step``
  with the hands split over ``hands`` ranks (every data row of a larger
  group does the same); each rank saves the solver's state (its slice of
  the hands) and the engine's steps (every hand);
* ``data_hands``: the SPMD programs with the ``fast`` engine on a
  ``data x hands`` grid: generation steps, then train steps; each rank
  saves the losses, its ring's counts and its net.

:func:`run_group` starts a group of ranks through
:func:`rebel_tpu_torch.parallel.launcher.launch_local` and returns their
outputs; a rank that fails or outlasts the timeout fails the group.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import torch

from rebel_tpu_torch.nets.convert import net_from_state_dict
from rebel_tpu_torch.nets.value_nets import net_value_fn
from rebel_tpu_torch.parallel import distributed
from rebel_tpu_torch.parallel import mesh as meshlib
from rebel_tpu_torch.parallel.launcher import launch_local
from rebel_tpu_torch.selfplay.fast_runner import FastSelfPlayEngine
from rebel_tpu_torch.selfplay.runner import (
    EpisodeState,
    RecursiveSolvingParams,
)
from rebel_tpu_torch.solving.core import RootCtx
from rebel_tpu_torch.solving.grid2 import Grid2Solver, local_hands
from rebel_tpu_torch.solving.params import SubgameSolvingParams

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def recursive_params(env: dict) -> RecursiveSolvingParams:
    """``{num_dice, num_faces, num_iters, use_cfr}`` as self-play
    parameters (linear updates, depth 2, exploration 0.25, leaf
    sampling)."""
    return RecursiveSolvingParams(
        num_dice=env["num_dice"], num_faces=env["num_faces"],
        subgame_params=SubgameSolvingParams(
            num_iters=env["num_iters"], max_depth=2, linear_update=True,
            use_cfr=env["use_cfr"]),
        random_action_prob=0.25, sample_leaf=True)


def make_trainer(spec: dict, device):
    """A trainer of ``spec``: ``env`` (see :func:`recursive_params`) and
    :class:`~rebel_tpu_torch.training.trainer.TrainerConfig` fields."""
    from rebel_tpu_torch.training.trainer import Trainer, TrainerConfig

    kw = {k: v for k, v in spec.items() if k != "env"}
    if "solver_dtype" in kw:
        kw["solver_dtype"] = DTYPES[kw["solver_dtype"]]
    return Trainer(TrainerConfig(env=recursive_params(spec["env"]), **kw),
                   device=device)


# ------------------------------------------------------------------ cases
def train_step_case(rt, inp: dict) -> dict:
    from rebel_tpu_torch.training.trainer import huber

    trainer = make_trainer(inp["trainer"], rt.device)
    layout = meshlib.make_layout()
    init_state, _, train_step = meshlib.make_spmd_programs(trainer, layout)
    state = init_state(0)
    trainer.net.load_state_dict(inp["net"])
    ring = inp["rings"][layout.data.index]
    for k in meshlib.RING_KEYS:
        getattr(state.replay, k)[:len(ring[k])] = ring[k].to(rt.device)
    for k in meshlib.COUNT_KEYS:
        setattr(state.replay, k, int(ring[k]))
    # The reference: one process's gradient of the loss on the batches
    # of every rank put together, clipped as the step clips.
    ref = net_from_state_dict(inp["net"], trainer.game).to(rt.device)
    idx = inp["indices"][0][layout.data.index].to(rt.device)
    rows = [layout.data.gather(getattr(state.replay, k)[idx], 0)
            for k in ("queries", "values")]
    huber(rows[1] - ref(rows[0])).mean(-1).mean().backward()
    ref_grad = torch.cat([p.grad.reshape(-1) for p in ref.parameters()])
    norm = ref_grad.norm()
    if norm >= trainer.cfg.grad_clip:
        ref_grad = ref_grad / norm * trainer.cfg.grad_clip
    nets, stats = [], []
    for step, indices in enumerate(inp["indices"]):
        stats.append({k: v.cpu() for k, v in train_step(
            state, indices[layout.data.index]).items()})
        if step == 0:
            grad = torch.cat([p.grad.reshape(-1)
                              for p in trainer.net.parameters()])
            grad_rel = float((grad - ref_grad).abs().max()
                             / ref_grad.abs().max())
        nets.append({k: v.detach().cpu().clone()
                     for k, v in trainer.net.state_dict().items()})
    return {"nets": nets, "stats": stats, "grad_rel": grad_rel}


def hands_case(rt, inp: dict) -> dict:
    layout = meshlib.make_layout(n_hands=inp["hands"])
    dev, dt = rt.device, DTYPES[inp["dtype"]]
    cfg = recursive_params(inp["env"])
    game = cfg.game
    net = net_from_state_dict(inp["net"], game).to(dev, dt)
    out = {}
    if "beliefs" in inp:
        solver = Grid2Solver(game, cfg.subgame_params, dt, net_value_fn(net),
                             device=dev, hands=layout.hands)
        root = RootCtx.of(game, inp["bids"].to(dev), inp["players"].to(dev))
        beliefs = local_hands(layout.hands, inp["beliefs"]).to(dev)
        with torch.no_grad():
            state = solver.multistep(solver.init(root, beliefs), root)
        out["solver"] = {k: v.cpu() for k, v in state._asdict().items()
                         if isinstance(v, torch.Tensor)}
    engine = FastSelfPlayEngine(cfg, dt, hands=layout.hands)
    out["engine"] = engine_steps(engine, net, inp["lanes"], inp["steps"],
                                 inp["seed"], dev, dt)
    return out


def engine_steps(engine, net, lanes: int, steps: int, seed: int, dev,
                 dt) -> list[dict]:
    """``steps`` batch steps of ``engine`` from the initial lanes with a
    generator seeded ``seed``: each step's outputs and episodes, on the
    host."""
    eps = EpisodeState.initial_batch(engine.cfg.game, lanes, dev, dt)
    gen = torch.Generator(dev).manual_seed(seed)
    got = []
    for _ in range(steps):
        eps, step = engine.batch_step(eps, net, gen)
        got.append({k: v.cpu() for k, v in
                    {**step._asdict(), **eps._asdict()}.items()})
    return got


def data_hands_case(rt, inp: dict) -> dict:
    trainer = make_trainer(inp["trainer"], rt.device)
    layout = meshlib.make_layout(n_hands=inp["hands"])
    init_state, gen_step, train_step = meshlib.make_spmd_programs(
        trainer, layout, hands=True)
    state = init_state(0)
    for _ in range(inp["gen_steps"]):
        gen_step(state)
    losses = [float(train_step(state)["loss"])
              for _ in range(inp["train_steps"])]
    return {"losses": losses, "num_add": state.replay.num_add,
            "size": state.replay.size,
            "net": meshlib.flat_params(trainer.net).cpu()}


CASES = {"train_step": train_step_case, "hands": hands_case,
         "data_hands": data_hands_case}


# ----------------------------------------------------------------- groups
def run_group(cases: dict, ranks: int, work: pathlib.Path,
              device: str = "cuda", timeout: float = 120.0) -> list[dict]:
    """Run ``cases`` (``{case: inputs}``, in turn) in ``ranks`` processes
    (one thread each) on ``device`` and return each rank's ``{case:
    outputs}``.  Raises when a rank exits non-zero or the group outlasts
    ``timeout`` seconds (its processes are stopped)."""
    work = pathlib.Path(work)
    work.mkdir(parents=True, exist_ok=True)
    torch.save(cases, work / "input.pt")
    rc = launch_local(
        [str(pathlib.Path(__file__).resolve()), str(work / "input.pt"),
         str(work / "out"), "--device", device], ranks, work,
        timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))
    if rc != 0:
        tails = "".join(f"\nrank {i}: " + (work / f"log.rank{i}.txt")
                        .read_text()[-2000:] for i in range(1, ranks))
        raise RuntimeError(f"{sorted(cases)}: a rank exited {rc} (rank 0 "
                           f"wrote to this process's streams){tails}")
    return [torch.load(work / f"out.rank{i}.pt", weights_only=True)
            for i in range(ranks)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output", help="prefix of rank i's output "
                    "<output>.rank<i>.pt")
    ap.add_argument("--dist", required=True, metavar="COORD,N,I")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    coord, n, i = args.dist.rsplit(",", 2)
    rt = distributed.initialize(coord, int(n), int(i), args.device)
    cases = torch.load(args.input, weights_only=True)
    out = {case: CASES[case](rt, inp) for case, inp in cases.items()}
    torch.save(out, f"{args.output}.rank{rt.rank}.pt")
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
