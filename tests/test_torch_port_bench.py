"""The port's generation benchmark entry (``python -m rebel_tpu_torch.bench``)
on the CPU: what it prints, what it refuses, and its FLOP count against the
JAX package's ``bench.py``.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from rebel_tpu_torch import bench
from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.solving import grid2p

REPO = pathlib.Path(__file__).resolve().parents[1]
DETAIL_KEYS = {
    "subgames_per_s", "examples_per_s", "batch", "num_iters", "wall_s",
    "mlp_model_flops_per_s", "mfu", "kernel_s", "launches", "card",
}
SIDE_KEYS = {"fp_iters_per_s", "no_net_cfr_iters_per_s"}


# A tiny run: the tests hold what the entry prints, not its speed.
TINY = ["--batch", "8", "--num_iters", "4", "--steps", "1", "--device",
        "cpu", "--deadline", "0"]


def _run(*argv):
    # One thread: the test workers run side by side, and a 256-wide net on
    # every core of each of them only makes them wait for each other.
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "rebel_tpu_torch.bench", *argv], cwd=REPO,
        capture_output=True, text=True, timeout=600, env=env)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_bench_flops():
    """``mlp_model_flops_per_subgame_iter`` of the JAX package's
    ``bench.py``, taken from its source: importing that script configures
    JAX's compilation cache as a side effect."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "mlp_model_flops_per_subgame_iter")
    scope = {}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), scope)
    return scope[fn.name]


def test_smoke_on_cpu_prints_two_json_lines():
    proc = _run("--smoke", "--device", "cpu", "--layout", "plain")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert len(lines) == 2
    head, full = lines
    for line in lines:
        assert set(line) == {"metric", "value", "unit", "vs_baseline",
                             "detail"}
        assert line["vs_baseline"] is None
        assert line["unit"] == "iters/s"
        assert line["metric"].startswith("CFR subgame-iters/s")
        assert line["value"] > 0
        assert DETAIL_KEYS <= set(line["detail"])
    assert head["value"] == full["value"]
    assert not SIDE_KEYS & set(head["detail"])
    assert SIDE_KEYS <= set(full["detail"])
    d = full["detail"]
    assert (d["batch"], d["num_iters"], d["device"]) == (64, 32, "cpu")
    assert d["fp_iters_per_s"] > 0 and d["no_net_cfr_iters_per_s"] > 0
    assert abs(full["value"] - d["subgames_per_s"] * 32) < 1e-6 * full["value"]
    assert abs(d["examples_per_s"] - 2 * d["subgames_per_s"]) < 1e-9 * d[
        "examples_per_s"]
    # Nothing measured on the CPU stands under a device metric's name.
    assert d["mfu"] is None and d["kernel_s"] is None and d["card"] is None
    assert d["launches"] == {}


def test_without_cuda_and_without_device_cpu_it_refuses():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    proc = _run("--smoke")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""  # no headline, no value
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("argv,metric", [
    (["--fp"], "FP subgame-iters/s per chip (1x4f, depth-2, CFV net fused)"),
    (["--no-net"], "CFR subgame-iters/s per chip (1x4f, depth-2, no net)"),
    (["--headline-only", "--interleave", "2", "--ablate", "noln",
      "--gelu", "exact", "--lane-block", "4", "--mlp-chunks", "2"],
     "CFR subgame-iters/s per chip (1x4f, depth-2, CFV net fused)"),
])
def test_main_narrowed_to_one_mode_prints_one_line(argv, metric, capsys,
                                                   one_thread):
    """``--fp``, ``--no-net`` and ``--headline-only`` skip the side
    measurements; the kernel layout on the CPU runs the plain version with
    the same options."""
    lines = bench.main([*TINY, *argv])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 1
    assert lines[0]["metric"] == metric
    assert lines[0]["detail"]["layout"] == "kernel"
    assert ("mfu" in lines[0]["detail"]) == ("--no-net" not in argv)


def test_cycles_print_items_per_second(capsys, one_thread):
    bench.main([*TINY, "--cycles", "2", "--headline-only", "--layout",
                "plain"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cycle 0: items 16 per_second ")
    assert out[1].startswith("cycle 1: items 32 per_second ")
    assert json.loads(out[2])["value"] > 0


def test_profile_writes_a_trace(tmp_path, capsys, one_thread):
    bench.main([*TINY, "--headline-only", "--layout", "plain", "--profile",
                str(tmp_path / "p")])
    capsys.readouterr()
    assert (tmp_path / "p" / "trace.json").stat().st_size > 0
    assert (tmp_path / "p" / "key_averages.txt").stat().st_size > 0


def test_bad_options_are_refused():
    for argv in (["--ablate", "nothing"], ["--gelu", "tanh"],
                 ["--layout", "nope"]):
        with pytest.raises(SystemExit):
            bench.parse_args(argv)
    with pytest.raises(ValueError, match="interleave"):
        bench.measure(8, 2, 1, interleave=3, device="cpu")


@pytest.mark.parametrize("dice,faces", [(1, 4), (1, 5), (1, 6), (2, 3)])
def test_flop_count_equals_the_jax_bench(dice, faces):
    want = _jax_bench_flops()(dice, faces)
    assert grid2p.mlp_flops_per_lane_iter(LiarsDice(dice, faces), 256,
                                          2) == want
    if (dice, faces) == (1, 4):
        assert want == 3_999_744  # 4.0 MFLOP: 28 pseudo-leaves x 142,848
    assert _jax_bench_flops()(dice, faces, 128, 3) == (
        grid2p.mlp_flops_per_lane_iter(LiarsDice(dice, faces), 128, 3))


@pytest.mark.parametrize("use_cfr,want", [(True, 4352), (False, 2732)],
                         ids=["cfr", "fp"])
def test_no_net_operation_count(use_cfr, want):
    """The arithmetic of a lane-iteration outside the MLP at 1x4f (A=9,
    H=4, D=2): reach grids 720, terminal values 10 x 38, backup 1440 (CFR)
    or 720 (FP), update 1800 or 900, running mean 12."""
    assert grid2p.nonet_ops_per_lane_iter(LiarsDice(1, 4), use_cfr) == want
    # Linear in the level-1 grid: 2x3f (A=13, H=9) holds 1521 + 117 cells.
    assert grid2p.nonet_ops_per_lane_iter(LiarsDice(2, 3), use_cfr) > \
        4 * want


def test_watchdog_prints_a_partial_line_with_an_error_key():
    """A run that outlives ``--deadline`` prints one JSON line with an
    ``error`` key and exits 3."""
    proc = _run("--device", "cpu", "--layout", "plain", "--batch", "64",
                "--num_iters", "100000", "--deadline", "2")
    assert proc.returncode == 3
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["value"] is None and "watchdog expired" in line["error"]


def test_batch_first_layout_runs_the_fast_engine(capsys, one_thread):
    """``--layout batch_first`` steps the ``fast`` engine (the batch-first
    solver in plain PyTorch), which launches no kernel and, as the JAX
    package's, needs a net."""
    (line,) = bench.main([*TINY, "--headline-only", "--layout",
                          "batch_first"])
    capsys.readouterr()
    d = line["detail"]
    assert d["layout"] == "batch_first" and line["value"] > 0
    assert d["launches"] == {} and d["lane_block"] is None
    with pytest.raises(ValueError, match="value_fn"):
        bench.main([*TINY, "--no-net", "--layout", "batch_first"])
