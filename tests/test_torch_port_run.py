"""The port's run entry (``python -m rebel_tpu_torch.run``) on the CPU: a
training run as users start it, every run mode, resume to the same
parameters as an uninterrupted run, the fallback over an unreadable
checkpoint, ``task=eval`` with the zero net, the refusals (cluster
management, a hands axis that does not divide the ranks, a card that is
not there), ``launcher.spmd=true`` in one process, and the stall
watchdog."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from rebel_tpu_torch import run
from rebel_tpu_torch.nets import convert
from rebel_tpu_torch.utils.watchdog import StallWatchdog

REPO = pathlib.Path(__file__).resolve().parents[1]
CONF = str(REPO / "conf" / "liars_sp.yaml")
TINY = ["selfplay.batch=8", "data.train_epoch_size=64",
        "data.train_batch_size=16", "env.num_faces=3",
        "env.subgame_params.num_iters=8", "model.kwargs.n_hidden=16",
        "model.kwargs.n_layers=1", "replay.capacity=512", "exploit=false",
        "checkpoint_every=1", "env.subgame_params.use_cfr=true"]


def entry(exp_dir, *args, mode="gentle_start"):
    return run.execute(["--cfg", CONF, "--device", "cpu", "--exp_dir",
                        str(exp_dir), "--mode", mode, *TINY, *args])


def epochs(exp_dir):
    return [json.loads(line)["epoch"] for line in
            (exp_dir / "metrics.jsonl").read_text().splitlines()]


def test_module_entry_trains_evaluates_and_checkpoints(tmp_path):
    """``python -m rebel_tpu_torch.run --device cpu --adhoc`` with small
    overrides: two epochs with the exploit evaluation (``eval_mse`` on),
    checkpoints, ``.params`` exports and ``result.json``."""
    proc = subprocess.run(
        [sys.executable, "-m", "rebel_tpu_torch.run", "--cfg", CONF,
         "--device", "cpu", "--adhoc", "--out_root", str(tmp_path), *TINY,
         "env.num_faces=2", "max_epochs=2", "exploit=true",
         "exploit_every=1", "eval_num_repeats=2", "eval_mse=true"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (exp_dir,) = (tmp_path / "liars_sp").iterdir()
    assert exp_dir.name.startswith("adhoc-")
    result = json.loads((exp_dir / "result.json").read_text())
    assert result["epochs"] == 2 and result["final"]["epoch"] == 1
    for k in ("exploitability_last", "exploitability_avg",
              "eval_mse/net_reach", "eval_mse/fp_reach"):
        assert 0 <= result["final"][k] < 2, k
    assert result["final"]["timing/exploit"] > 0
    assert json.loads((exp_dir / "config.json").read_text())["max_epochs"] \
        == 2
    assert (exp_dir / "heartbeat").exists()
    assert epochs(exp_dir) == [0, 1]
    names = sorted(p.name for p in (exp_dir / "ckpt").iterdir())
    assert names == ["epoch0.ckpt", "epoch0.params", "epoch1.ckpt",
                     "epoch1.params"]
    assert "Git SHA" in proc.stderr and "torch" in proc.stderr


def test_resume_equals_uninterrupted_run(tmp_path):
    """Two epochs, then ``--mode start_continue`` to three: the same
    parameters (``torch.equal``) as three epochs in one run; the resumed
    run writes one epoch line and carries the ring's count on."""
    straight = entry(tmp_path / "a", "max_epochs=3")
    entry(tmp_path / "b", "max_epochs=2")
    before = json.loads((tmp_path / "b" / "metrics.jsonl").read_text()
                        .splitlines()[-1])
    resumed = entry(tmp_path / "b", "max_epochs=3", mode="start_continue")
    assert epochs(tmp_path / "b") == [0, 1, 2]
    assert resumed.result["final"]["buffer/added"] >= before["buffer/added"]
    for x, y in zip(straight.trainer.net.parameters(),
                    resumed.trainer.net.parameters()):
        assert torch.equal(x, y)
    # The .params export of the last epoch is the live net.
    net = convert.load_params_net(tmp_path / "b" / "ckpt" / "epoch2.params",
                                  resumed.trainer.game, "cpu")
    q = torch.rand(32, resumed.trainer.game.query_size)
    assert torch.equal(net(q), resumed.trainer.net(q))


def test_resume_falls_back_over_unreadable_checkpoint(tmp_path):
    entry(tmp_path, "max_epochs=2")
    (tmp_path / "ckpt" / "epoch1.ckpt").write_bytes(b"truncated")
    resumed = entry(tmp_path, "max_epochs=2", mode="start_continue")
    # Resumed from epoch0.ckpt: epoch 1 is trained again.
    assert resumed.trainer.epoch == 2
    assert epochs(tmp_path) == [0, 1, 1]


@pytest.mark.parametrize("mode,runs", [
    ("gentle_start", False), ("start_restart", True), ("restart", True),
    ("dryrun", False), ("start_continue", True)])
def test_modes_on_a_finished_experiment(tmp_path, mode, runs):
    entry(tmp_path, "max_epochs=1")
    again = entry(tmp_path, "max_epochs=1", mode=mode)
    assert (again.result is not None) == runs
    # start_continue resumes past max_epochs: nothing left to train.
    expect = {"start_continue": [0], "gentle_start": [0], "dryrun": [0]}
    assert epochs(tmp_path) == expect.get(mode, [0])
    assert (tmp_path / "result.json").exists()


def test_eval_task_with_the_zero_net(tmp_path):
    out = entry(tmp_path, "task=eval", "eval.net=zero",
                "eval.subgame_iters=4", "eval.num_repeats=2", "eval.f64=false")
    assert out.trainer is None
    result = json.loads((tmp_path / "result.json").read_text())
    assert set(result["exploitability"]) == {"full_tree",
                                             "repeated toleaf 2"}
    assert result["net_compute_dtype"] == "float32"
    assert (tmp_path / "eval.1x3-cfr.partial").exists()


@pytest.mark.parametrize("args", [
    ["--mode", "submit"], ["--mode", "cluster_status"],
    ["launcher.num_processes=2", "launcher.hands=3"], ["--device", "cuda"]])
def test_refusals(tmp_path, args):
    if args == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("CUDA is available; the refusal needs a host without it")
    with pytest.raises(SystemExit):
        run.execute(["--cfg", CONF, "--exp_dir", str(tmp_path / "x"),
                     *(["--device", "cpu"] if "--device" not in args
                       else []), *TINY, *args])
    assert not (tmp_path / "x" / "result.json").exists()


def test_spmd_in_one_process_ignores_hands(tmp_path, caplog):
    """``launcher.spmd=true launcher.hands=2`` where one process runs (on
    the CPU, or with one card) trains in that process and ignores the
    hands axis, as the JAX package does at one device."""
    caplog.set_level("INFO")
    out = entry(tmp_path, "launcher.spmd=true", "launcher.hands=2",
                "max_epochs=1")
    assert out.code == 0 and epochs(tmp_path) == [0]
    assert "launcher.hands=2 unused by one process" in caplog.text
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["processes"] == 1 and result["backend"] is None
    # The CPU runs the kernels' plain versions: nothing launched.
    (launches,) = result["kernel_launches"]
    assert launches and not any(launches.values())


def test_watchdog_exits_87_with_a_stalled_file(tmp_path):
    code = (f"import sys, time; sys.path.insert(0, {str(REPO)!r})\n"
            "from rebel_tpu_torch.utils.watchdog import StallWatchdog\n"
            f"wd = StallWatchdog(1.0, {str(tmp_path)!r}, what='test')"
            ".start()\nwd.alive(7)\ntime.sleep(120)\n")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          timeout=60)
    assert proc.returncode == 87, proc.stderr[-500:]
    assert time.time() - t0 < 30
    marker = json.loads((tmp_path / "STALLED").read_text())
    assert marker["last_tag"] == 7 and marker["what"] == "test"
    assert StallWatchdog(0, tmp_path).start()._thread is None
    fed = StallWatchdog(30.0, tmp_path / "fed").start()
    fed.alive(1)
    fed.stop()
    assert not (tmp_path / "fed" / "STALLED").exists()


def test_selfplay_engine_fast_trains(tmp_path):
    """``selfplay.engine=fast`` (the JAX package's batch-first engine)
    trains and checkpoints through the run entry."""
    out = entry(tmp_path / "fast", "selfplay.engine=fast", "max_epochs=1")
    assert type(out.trainer.engine).__name__ == "FastSelfPlayEngine"
    assert epochs(tmp_path / "fast") == [0]
    assert (tmp_path / "fast" / "ckpt" / "epoch0.params").exists()
