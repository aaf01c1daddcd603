"""The port's SPMD path on the CPU: ``rebel_tpu_torch.parallel``
(runtime, launcher, rank layout, SPMD programs), the hands axis of the
batch-first solver and the ``fast`` engine, ``Trainer.run_spmd`` and the
run entry's several processes.

The port's ranks are CPU processes over gloo that import torch and
``rebel_tpu_torch`` only (``spmd_parity.run_group`` or ``python -m
rebel_tpu_torch.run``); every group has its own timeout, so a hung
collective fails the test.  The JAX side runs in the test process on the
conftest's eight virtual devices, while the ranks run.  Held:

* ``train_step`` against the JAX package's ``make_spmd_programs(...)[2]``
  on a two-device mesh, on the same ring rows with the slots the JAX step
  draws, parameters and statistics to 1e-6 (f32); the averaged gradient
  against one process's on both batches put together;
* the hands-split ``Grid2Solver.multistep`` at 2x3f (three ranks, f64, 16
  iterations, a 16x1 net) against the JAX package's unsplit one, and the
  hands-split ``fast`` engine against the port's unsplit one with the
  same draws, at 1e-12 (``tests/test_hands_sharding.py``'s tolerance);
* data x hands 2 x 3: generation and training run, the net stays the same
  on every rank;
* the run entry's two ranks end to end (``tests/test_launcher.py``'s
  assertions), ``--mode kill``, the three PID-safety cases of
  ``kill_experiment``;
* a two-rank run of two epochs resumed to a third equals a straight run
  of three (``torch.equal``), and a resume onto another data-axis size
  restores the net and the optimizer only, with the JAX package's
  warning.
"""

import importlib.util
import json
import logging
import os
import pathlib
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.parallel import mesh as jmesh
from rebel_tpu.selfplay import replay as jrb
from rebel_tpu.selfplay.runner import RecursiveSolvingParams as JRecursive
from rebel_tpu.solving.core import RootCtx as JRootCtx
from rebel_tpu.solving.grid2 import Grid2Solver as JGrid2Solver
from rebel_tpu.solving.params import SubgameSolvingParams as JParams
from rebel_tpu.training.trainer import Trainer as JTrainer
from rebel_tpu.training.trainer import TrainerConfig as JTrainerConfig

from rebel_tpu_torch.nets.convert import from_flax, net_from_state_dict
from rebel_tpu_torch.parallel import distributed, launcher, mesh
from rebel_tpu_torch.selfplay.fast_runner import FastSelfPlayEngine
from rebel_tpu_torch.training.trainer import Trainer, spmd_checkpoints

REPO = pathlib.Path(__file__).resolve().parents[1]
CONF = str(REPO / "conf" / "liars_sp.yaml")
f32 = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
# The run entry's tiny two-rank configuration.
TINY = ["selfplay.batch=8", "data.train_epoch_size=32",
        "data.train_batch_size=16", "env.num_faces=3",
        "env.subgame_params.num_iters=8", "model.kwargs.n_hidden=16",
        "model.kwargs.n_layers=1", "replay.capacity=512", "exploit=false",
        "checkpoint_every=1", "env.subgame_params.use_cfr=true",
        "launcher.num_processes=2", "launcher.spmd=true"]
RUN_TIMEOUT = 180
_spec = importlib.util.spec_from_file_location("spmd_parity",
                                               REPO / "spmd_parity.py")
parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(parity)


def run_group_bg(pool, cases: dict, ranks: int, work):
    """``parity.run_group`` on the CPU in a thread of ``pool``, so that
    the JAX side runs meanwhile."""
    return pool.submit(parity.run_group, cases, ranks, work, device="cpu")


def run_entry(*args, timeout=RUN_TIMEOUT):
    """``python -m rebel_tpu_torch.run`` on the CPU, one thread a rank."""
    return subprocess.run(
        [sys.executable, "-m", "rebel_tpu_torch.run", "--cfg", CONF,
         "--device", "cpu", *args], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))


# ------------------------------------------------------------ train step
def test_train_step_matches_jax(tmp_path):
    n_dev, steps, lanes, batch = 2, 3, 8, 16
    jcfg = JTrainerConfig(
        env=JRecursive(num_dice=1, num_faces=4,
                       subgame_params=JParams(num_iters=8, max_depth=2,
                                              linear_update=True,
                                              use_cfr=True),
                       random_action_prob=0.25, sample_leaf=True),
        n_hidden=32, n_layers=2, selfplay_batch=lanes,
        train_batch_size=batch, train_epoch_size=batch, replay_capacity=64,
        engine="fast")
    jtr = JTrainer(jcfg, out_dir=tmp_path / "jax")
    mesh2 = jmesh.make_mesh(n_dev)
    init_state, _, jtrain = jmesh.make_spmd_programs(jtr, mesh2)
    st = init_state(seed=0)
    game = jtr.game
    cap = st.replay.queries.shape[0] // n_dev
    local = batch // n_dev
    rng = np.random.RandomState(5)
    heads, sizes, added = [20, 7], [20, cap], [20, cap + 7]
    host = jrb.Replay(
        queries=rng.rand(n_dev * cap, game.query_size).astype(np.float32),
        values=(rng.randn(n_dev * cap, game.num_hands) * 0.7).astype(
            np.float32),
        priorities=np.ones(n_dev * cap, np.float32),
        head=np.asarray(heads, np.int32), size=np.asarray(sizes, np.int32),
        num_add=np.asarray(added, np.int32))
    replay = jmesh.shard_batch(mesh2, jax.tree.map(jnp.asarray, host))

    # The slots the JAX step draws (rb.sample_uniform with the key split
    # at mesh.py:276), computed from its keys.
    keys, indices = np.asarray(st.keys), []
    for _ in range(steps):
        step_idx, new_keys = [], []
        for d in range(n_dev):
            key, k = jax.random.split(jnp.asarray(keys[d]))
            off = jax.random.randint(k, (local,), 0, max(sizes[d], 1))
            step_idx.append(np.asarray((heads[d] - 1 - off) % cap))
            new_keys.append(np.asarray(key))
        keys = np.stack(new_keys)
        indices.append(step_idx)
    rings = [{"queries": torch.from_numpy(host.queries[d * cap:(d + 1) * cap]),
              "values": torch.from_numpy(host.values[d * cap:(d + 1) * cap]),
              "priorities": torch.from_numpy(
                  host.priorities[d * cap:(d + 1) * cap]),
              "head": heads[d], "size": sizes[d], "num_add": added[d]}
             for d in range(n_dev)]
    with ThreadPoolExecutor(1) as pool:
        group = run_group_bg(pool, {"train_step": {
            "trainer": dict(env=dict(num_dice=1, num_faces=4, num_iters=8,
                                     use_cfr=True),
                            n_hidden=32, n_layers=2, selfplay_batch=lanes,
                            train_batch_size=batch, train_epoch_size=batch,
                            replay_capacity=64),
            "net": from_flax(f32(st.params)), "rings": rings,
            "indices": torch.as_tensor(np.asarray(indices))}}, n_dev,
            tmp_path / "port")
        params, opt_state, jkeys = st.params, st.opt_state, st.keys
        want = []
        for _ in range(steps):
            params, opt_state, jkeys, stats = jtrain(params, opt_state,
                                                     replay, jkeys)
            want.append((from_flax(f32(params)),
                         jax.tree.map(np.asarray, stats)))
        np.testing.assert_array_equal(np.asarray(jkeys), keys)
        outs = group.result()
    outs = [o["train_step"] for o in outs]
    for step, (want_net, want_stats) in enumerate(want):
        for k, v in want_net.items():
            torch.testing.assert_close(outs[0]["nets"][step][k], v,
                                       atol=1e-6, rtol=0, msg=k)
            assert torch.equal(outs[1]["nets"][step][k],
                               outs[0]["nets"][step][k])
        for k, v in want_stats.items():
            np.testing.assert_allclose(outs[0]["stats"][step][k].numpy(), v,
                                       atol=1e-6, err_msg=k)
    assert outs[0]["grad_rel"] <= 1e-6 and outs[1]["grad_rel"] <= 1e-6


# ------------------------------------------------------------- hands axis
HANDS_ENV = dict(num_dice=2, num_faces=3, num_iters=16, use_cfr=True)
HANDS_RANKS = 3
HANDS_LANES, HANDS_STEPS, HANDS_SEED = 4, 2, 7


@pytest.fixture(scope="module")
def hands_run(tmp_path_factory):
    """One group of six ranks, data x hands 2 x 3, at 2x3f (H = 9): in f64
    with a 16x1 net, the hands-split solve and engine (the two data rows
    alike); then the SPMD programs with the ``fast`` engine.  And the JAX
    package's unsplit solve on the same inputs, while the ranks run."""
    jgame = JLiarsDice(num_dice=2, num_faces=3)
    spec = CFVNetSpec(game=jgame, n_hidden=16, n_layers=1,
                      compute_dtype=jnp.float64)
    params = spec.init_params(jax.random.PRNGKey(0))
    beliefs = np.random.RandomState(3).dirichlet(np.ones(jgame.num_hands),
                                                 size=2)
    net = from_flax(f32(params))
    with ThreadPoolExecutor(1) as pool:
        group = run_group_bg(pool, {
            "hands": {"env": HANDS_ENV, "dtype": "float64", "net": net,
                      "hands": HANDS_RANKS,
                      "beliefs": torch.as_tensor(beliefs)[None],
                      "bids": torch.tensor([2]),
                      "players": torch.tensor([1]), "lanes": HANDS_LANES,
                      "steps": HANDS_STEPS, "seed": HANDS_SEED},
            "data_hands": {
                "trainer": dict(env=dict(num_dice=2, num_faces=3,
                                         num_iters=8, use_cfr=True),
                                n_hidden=16, n_layers=1, engine="fast",
                                selfplay_batch=8, train_batch_size=8,
                                train_epoch_size=8, replay_capacity=256,
                                solver_dtype="float32"),
                "hands": HANDS_RANKS, "gen_steps": 3, "train_steps": 3}},
            2 * HANDS_RANKS, tmp_path_factory.mktemp("hands"))
        plain = JGrid2Solver(
            game=jgame, params=JParams(num_iters=HANDS_ENV["num_iters"],
                                       max_depth=2, linear_update=True,
                                       use_cfr=True),
            dtype=jnp.float64,
            value_fn=spec.value_fn(jax.tree.map(
                lambda x: jnp.asarray(x, jnp.float64), params)))
        root = JRootCtx.of(jgame, 2, 1)
        expect = jax.jit(plain.multistep)(
            plain.init(root, jnp.asarray(beliefs)), root)
        outs = group.result()
    return outs, expect, net


# Where each state tensor keeps its hands: (port axis, JAX axis).
HANDS_AXIS = {"root_values_means": (2, 1), "sum1": (2, 1), "last0": (1, 0),
              "regrets0": (1, 0), "regrets1": (2, 1), "sum0": (1, 0),
              "last1": (2, 1)}


@pytest.mark.parametrize("key", list(HANDS_AXIS))
def test_hands_split_solve_matches_jax(hands_run, key):
    outs, expect, _ = hands_run
    port_axis, _ = HANDS_AXIS[key]
    got = torch.cat([o["hands"]["solver"][key]
                     for o in outs[:HANDS_RANKS]], port_axis)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(expect, key)),
                               atol=1e-12)


def test_hands_split_engine_matches_unsplit(hands_run):
    outs, _, net = hands_run
    cfg = parity.recursive_params(HANDS_ENV)
    ref = parity.engine_steps(
        FastSelfPlayEngine(cfg, torch.float64),
        net_from_state_dict(net, cfg.game).double(), HANDS_LANES,
        HANDS_STEPS, HANDS_SEED, torch.device("cpu"), torch.float64)
    for out in outs:
        for got, want in zip(out["hands"]["engine"], ref):
            for k, v in want.items():
                if v.is_floating_point():
                    np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                               atol=1e-12, err_msg=k)
                else:
                    assert torch.equal(got[k], v), k


def test_data_by_hands_generates_and_trains(hands_run):
    outs, _, _ = hands_run
    outs = [o["data_hands"] for o in outs]
    assert all(np.isfinite(o["losses"]).all() for o in outs)
    assert all(o["num_add"] == 3 * 2 * 4 and o["size"] > 0 for o in outs)
    assert all(torch.equal(o["net"], outs[0]["net"]) for o in outs)
    # The ranks of one data shard hold the same losses (their rings are
    # the same).
    assert outs[0]["losses"] == outs[2]["losses"]


def test_hands_need_the_fast_engine_and_a_divisor(tmp_path):
    layout = mesh.RankLayout(1, 2, 0, distributed.Axis(distributed.SOLO, 1, 0),
                             distributed.Axis(distributed.SOLO, 2, 0))
    kw = dict(env=dict(num_dice=2, num_faces=3, num_iters=4, use_cfr=True),
              n_hidden=16, n_layers=1, selfplay_batch=4,
              train_batch_size=4, train_epoch_size=4, replay_capacity=64)
    with pytest.raises(ValueError, match="does not support hands sharding"):
        mesh.make_spmd_programs(parity.make_trainer(kw, "cpu"), layout,
                                hands=True)
    with pytest.raises(AssertionError, match="must divide"):
        mesh.make_spmd_programs(
            parity.make_trainer({**kw, "engine": "fast"}, "cpu"), layout,
            hands=True)


# --------------------------------------------------------- host helpers
def test_ring_helpers_match_jax():
    n_dev, cap, Q, H = 3, 5, 4, 2
    rng = np.random.RandomState(1)
    rows_q = rng.rand(13, Q).astype(np.float32)
    rows_v = rng.rand(13, H).astype(np.float32)
    base = dict(queries=np.zeros((n_dev * cap, Q), np.float32),
                values=np.zeros((n_dev * cap, H), np.float32),
                priorities=np.zeros((n_dev * cap,), np.float32))
    got = mesh.rows_to_ring(base, rows_q, rows_v, n_dev)
    want = jmesh.rows_to_ring(
        jrb.Replay(**base, head=np.zeros(n_dev, np.int32),
                   size=np.zeros(n_dev, np.int32),
                   num_add=np.zeros(n_dev, np.int32)),
        rows_q, rows_v, n_dev)
    for k in mesh.RING_KEYS + mesh.COUNT_KEYS:
        np.testing.assert_array_equal(got[k], getattr(want, k), err_msg=k)
    for a, b in zip(mesh.ring_valid_rows(got, n_dev),
                    jmesh.ring_valid_rows(want, n_dev)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1234", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     dict(coordinator="h0:1234", num_processes=4, process_id=3,
          local_rank=1, local_world=2)),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "4(x2)", "SLURM_JOB_NODELIST": "gpu[07-08]"},
     dict(coordinator="gpu07:29500", num_processes=8, process_id=5,
          local_rank=1, local_world=4)),
], ids=["none", "torchrun", "slurm"])
def test_detect_env(env, want):
    assert distributed.detect_env(env) == want


def test_backend_rule_and_one_process():
    cpu = torch.device("cpu")
    assert distributed.backend_for(cpu, 2) == "gloo"
    # Without a card every rank shares none: never nccl.
    assert distributed.backend_for(torch.device("cuda", 0), 2) == "gloo"
    rt = distributed.initialize(num_processes=1, device="cpu")
    assert rt == distributed.Runtime(0, 1, 0, cpu, None)
    t = torch.arange(3.0)
    assert distributed.all_reduce_(t) is t
    assert torch.equal(distributed.all_gather(t), t)


# ----------------------------------------------------- the run entry
@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """The run entry's two ranks, two epochs, a checkpoint each (the
    launch of tests/test_launcher.py); and meanwhile a straight run of
    three epochs, for the resume test."""
    root = tmp_path_factory.mktemp("launch")
    straight = tmp_path_factory.mktemp("straight")
    with ThreadPoolExecutor(1) as pool:
        run3 = pool.submit(run_entry, "--exp_dir", str(straight), *TINY,
                           "max_epochs=3")
        proc = run_entry("--adhoc", "--out_root", str(root), *TINY,
                         "max_epochs=2")
        return proc, root, (run3.result(), straight)


def test_launch_local_two_process_spmd(two_rank_run):
    proc, root, _ = two_rank_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = list(root.glob("*/*/result.json"))
    assert len(results) == 1, (proc.stdout[-1000:], proc.stderr[-1000:])
    result = json.loads(results[0].read_text())
    assert result["processes"] == 2 and result["devices"] == 2
    assert result["epochs"] == 2 and result["backend"] == "gloo"
    exp_dir = results[0].parent
    assert (exp_dir / "log.rank1.txt").exists()
    assert not (exp_dir / "jobs.json").exists()
    lines = [json.loads(x) for x in
             (exp_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in lines] == [0, 1]
    assert all(m["spmd/processes"] == 2 and np.isfinite(m["loss/train"])
               for m in lines)
    assert "rank 1 epoch 1: net equal on all 2 ranks" in (
        exp_dir / "log.rank1.txt").read_text()


def test_resumed_two_rank_run_equals_a_straight_one(two_rank_run, tmp_path,
                                                    caplog):
    proc, root, (straight, straight_dir) = two_rank_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert straight.returncode == 0, straight.stderr[-3000:]
    (exp_dir,) = [p.parent for p in root.glob("*/*/result.json")]
    resumed = run_entry("--exp_dir", str(exp_dir), "--mode",
                        "start_continue", *TINY, "max_epochs=3")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "resumed from" in resumed.stderr and "full state" in resumed.stderr
    a, b = (torch.load(d / "ckpt" / "epoch2.spmd.ckpt", weights_only=True)
            for d in (exp_dir, straight_dir))
    assert_same(a, b)
    assert a["n_data"] == 2 and a["generators"].shape[0] == 2

    # Onto one rank (a data axis of 1): the net and the optimizer only.
    caplog.set_level(logging.WARNING)
    cfg_dir = tmp_path / "one"
    (cfg_dir / "ckpt").mkdir(parents=True)
    ckpt = spmd_checkpoints(exp_dir / "ckpt")[-1]
    (cfg_dir / "ckpt" / ckpt.name).write_bytes(ckpt.read_bytes())
    from rebel_tpu_torch import config as cfglib

    cfg = cfglib.apply_overrides(cfglib.load_yaml_config(CONF), TINY)
    cfg.pop("launcher")
    trainer = Trainer(cfglib.cfg_to_trainer_config(cfg), device="cpu",
                      out_dir=cfg_dir)
    torch.set_num_threads(1)
    _, metrics = trainer.run_spmd(max_epochs=3)  # burn-in only
    assert "2-wide data axis but the layout has 1" in caplog.text
    assert metrics == [] and trainer.epoch == 3
    saved = torch.load(ckpt, weights_only=True)
    assert_same(trainer.net.state_dict(), saved["net"])
    assert_same(trainer.opt.state_dict(), saved["optimizer"])
    assert trainer.step == saved["step"]
    # Fresh rings from a stream seeded past the resume epoch.
    n = trainer.replay.size
    assert n > 0 and not torch.equal(trainer.replay.queries[:n],
                                     saved["replay"]["queries"][:n])


def assert_same(a, b, path="state"):
    """``a`` and ``b`` hold the same tensors (``torch.equal``) and values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_mode_kill_stops_a_running_group(tmp_path):
    exp_dir = tmp_path / "long"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    group = subprocess.Popen(
        [sys.executable, "-m", "rebel_tpu_torch.run", "--cfg", CONF,
         "--device", "cpu", "--exp_dir", str(exp_dir), *TINY,
         "max_epochs=100000"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while not (exp_dir / "jobs.json").exists():
            assert group.poll() is None and time.time() < deadline
            time.sleep(0.2)
        procs = json.loads((exp_dir / "jobs.json").read_text())["procs"]
        kill = run_entry("--exp_dir", str(exp_dir), "--mode", "kill", *TINY,
                         timeout=60)
        assert kill.returncode == 0, kill.stderr[-2000:]
        assert "killed 2 processes" in kill.stderr
        assert group.wait(timeout=60) != 0
        assert not (exp_dir / "jobs.json").exists()
        assert not any(launcher._pid_matches(j["pid"], j["argv"])
                       for j in procs)
    finally:
        if group.poll() is None:
            group.kill()


def test_kill_refuses_a_cluster_submission(tmp_path):
    (tmp_path / "cluster.json").write_text(json.dumps({"submitted": True}))
    with pytest.raises(SystemExit, match="not ported"):
        from rebel_tpu_torch import run

        run.execute(["--cfg", CONF, "--device", "cpu", "--exp_dir",
                     str(tmp_path), "--mode", "kill"])


# ----------------------------------------------- kill_experiment's PIDs
def test_kill_experiment_ignores_recycled_pids(tmp_path):
    jobs = {"coordinator": "127.0.0.1:1",
            "procs": [{"pid": 1, "rank": 0, "argv": ["definitely-not-init"]}]}
    (tmp_path / "jobs.json").write_text(json.dumps(jobs))
    assert launcher.kill_experiment(tmp_path) == 0


def test_kill_experiment_signals_recorded_pids(tmp_path):
    argv = [sys.executable, "-c", "import time; time.sleep(60)"]
    p = subprocess.Popen(argv)
    try:
        # The recorded command line is the child's once it has started.
        deadline = time.time() + 30
        while not launcher._pid_matches(p.pid, argv):
            assert time.time() < deadline
            time.sleep(0.05)
        jobs = {"coordinator": "127.0.0.1:1",
                "procs": [{"pid": p.pid, "rank": 0, "argv": argv}]}
        (tmp_path / "jobs.json").write_text(json.dumps(jobs))
        assert launcher.kill_experiment(tmp_path) == 1
        assert p.wait(timeout=10) == -signal.SIGTERM
        assert not (tmp_path / "jobs.json").exists()
    finally:
        if p.poll() is None:
            p.kill()


def test_launch_local_stops_a_group_that_outlasts_its_timeout(tmp_path):
    argv = ["-c", "import os, sys, time; print(os.environ['MARK'], "
            "sys.argv[-1], flush=True); time.sleep(60)"]
    t0 = time.time()
    with pytest.raises(TimeoutError, match="outlasted 3.0 s"):
        launcher.launch_local(argv, 2, tmp_path, timeout=3.0,
                              env=dict(os.environ, MARK="mark"))
    assert time.time() - t0 < 20
    assert not (tmp_path / "jobs.json").exists()
    # Rank 1 saw the environment and its --dist before it was stopped.
    log = (tmp_path / "log.rank1.txt").read_text()
    assert log.startswith("mark 127.0.0.1:") and log.endswith(",2,1\n")


def test_kill_experiment_no_jobs_file(tmp_path):
    assert launcher.kill_experiment(tmp_path) == 0
