"""The port's small surfaces against the JAX package's on the CPU: the
timers (``utils/timers.py``), the strategy printer
(``solving/printing.py``), the TorchScript export
(``nets/convert.export_torchscript``) and the host replay store
(``selfplay/host_store.py``)."""

import io
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rebel_tpu import LiarsDice as JLiarsDice
from rebel_tpu import unroll_tree as junroll_tree
from rebel_tpu.nets.cfv_net import CFVNetSpec
from rebel_tpu.nets.torch_import import export_torchscript as jexport
from rebel_tpu.selfplay import host_store as jhost_store
from rebel_tpu.solving import printing as jprinting
from rebel_tpu.utils import timers as jtimers

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.convert import (
    export_torchscript,
    from_flax,
    net_from_state_dict,
)
from rebel_tpu_torch.selfplay import host_store, refrng
from rebel_tpu_torch.selfplay import replay as rb
from rebel_tpu_torch.solving import printing
from rebel_tpu_torch.tree import unroll_tree
from rebel_tpu_torch.utils import timers


class Clock:
    """A host clock that moves only when told to."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def drive(mod, clock: Clock) -> dict:
    """The same sequence of phases and counts through ``mod``'s timers."""
    sw = mod.StopWatchTimer()
    multi = mod.MultiStopWatchTimer()
    frac, mx = mod.FractionCounter(), mod.MaxCounter()
    out = {"max_empty": mx.value(), "frac_empty": frac.value()}
    for phase, dt, num, den in (("gen", 1.5, 3, 4), ("train", 0.25, 1, 1),
                                ("gen", 2.0, 0, 2), ("eval", 0.5, 5, 10)):
        multi.start(phase)
        clock.now += dt
        frac.update(num, den)
        mx.update(dt)
    running = sw.running_time
    sw.stop()
    multi.stop()
    clock.now += 7.0
    return {**out, "running": running, "elapsed": sw.elapsed,
            "after_stop": sw.running_time, "timings": multi.timings,
            "metrics": multi.metrics(denominator=2.0), "frac": frac.value(),
            "max": mx.value()}


def test_timers_match_jax(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(timers.time, "time", clock)
    monkeypatch.setattr(jtimers.time, "time", clock)
    got, want = drive(timers, clock), drive(jtimers, clock)
    assert got == want
    assert got["timings"] == {"gen": 3.5, "train": 0.25, "eval": 0.5}
    assert set(got["metrics"]) == {f"{p}/{k}" for p in ("timing",
                                                        "timing_pct")
                                   for k in ("gen", "train", "eval")}


@pytest.mark.parametrize("dice,faces,depth", [(1, 2, 2), (1, 4, 3),
                                              (2, 2, 2)])
def test_print_strategy_text_is_the_jax_packages(tmp_path, dice, faces,
                                                 depth):
    game, jgame = LiarsDice(dice, faces), JLiarsDice(dice, faces)
    tree = unroll_tree(game, max_depth=depth)
    jtree = junroll_tree(jgame, max_depth=depth)
    strat = np.random.RandomState(dice * 10 + faces).dirichlet(
        np.ones(game.num_actions), size=(tree.num_nodes, game.num_hands))
    got, want = io.StringIO(), io.StringIO()
    printing.print_strategy(game, tree, torch.as_tensor(strat), got)
    jprinting.print_strategy(jgame, jtree, strat, want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith("Printing strategies per node\n")
    path = tmp_path / "s.txt"
    printing.print_strategy_to_file(game, tree, strat, path)
    assert path.read_text() == want.getvalue()


STANDALONE = """
import sys
import numpy as np
import torch
x = torch.from_numpy(np.load(sys.argv[1]))
outs = [torch.jit.load(p)(x).detach().numpy() for p in sys.argv[2:4]]
assert not any(m.startswith(("rebel_tpu", "jax")) for m in sys.modules)
np.save(sys.argv[4], np.stack(outs))
"""


@pytest.mark.parametrize("use_ln", [True, False])
def test_torchscript_export_loads_standalone(tmp_path, use_ln):
    """The archive loads with ``torch.jit.load`` in a process that has
    not imported the port, and computes what the JAX package's export of
    the same parameters computes."""
    jgame = JLiarsDice(num_dice=1, num_faces=4)
    spec = CFVNetSpec(game=jgame, n_hidden=32, n_layers=2,
                      use_layer_norm=use_ln)
    params = spec.init_params(jax.random.PRNGKey(7))
    net = net_from_state_dict(
        from_flax(jax.tree.map(np.asarray, params)), LiarsDice(1, 4))
    ours, theirs = tmp_path / "port.pt", tmp_path / "jax.pt"
    assert export_torchscript(net, ours) == str(ours)
    jexport(params, spec, str(theirs))
    x = np.random.RandomState(4).rand(16, jgame.query_size).astype(
        np.float32)
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", STANDALONE, str(tmp_path / "x.npy"),
         str(ours), str(theirs), str(tmp_path / "y.npy")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got, want = np.load(tmp_path / "y.npy")
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(spec.value_fn(params)(x)),
                               atol=2e-6)


def _rows(n, q=3, h=2, shift=0.0):
    return (np.arange(n * q, dtype=np.float32).reshape(n, q) + shift,
            np.arange(n * h, dtype=np.float32).reshape(n, h) + shift)


def test_host_store_round_trips_and_reads_the_jax_packages(tmp_path):
    store = host_store.HostReplayStore(query_size=3, num_hands=2)
    q, v = _rows(4)
    store.append(q, v)
    store.append(torch.from_numpy(q + 100), torch.from_numpy(v + 100))
    assert len(store) == 8
    q2, v2 = store.read(2, 4)
    np.testing.assert_array_equal(q2[:2], q[2:])
    np.testing.assert_array_equal(q2[2:], q[:2] + 100)
    assert store.read(6, 10)[0].shape == (2, 3)

    # Each package's store reads the other's dump, and the port's ring
    # reads the store's.
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    assert store.save(ours) == 8
    jstore = jhost_store.HostReplayStore(query_size=3, num_hands=2)
    jstore.append(q, v)
    assert jstore.save(str(theirs)) == 4
    assert ours.read_bytes()[:theirs.stat().st_size] == theirs.read_bytes()
    back = host_store.HostReplayStore(3, 2)
    assert back.load(theirs) == 4
    np.testing.assert_array_equal(back.read(0, 4)[1], v)
    jback = jhost_store.HostReplayStore(3, 2)
    assert jback.load(str(ours), max_rows=0, stride=2) == 4
    np.testing.assert_array_equal(jback.read(0, 4)[0][2:], q[::2] + 100)
    qs, vs = rb.load_file(ours)
    np.testing.assert_array_equal(qs[:4], q)
    np.testing.assert_array_equal(vs[4:], v + 100)

    # The store reads the ring's dump.
    ring = rb.create(8, 3, 2, "cpu")
    rb.add(ring, torch.from_numpy(q), torch.from_numpy(v))
    rb.save(ring, tmp_path / "ring.bin")
    again = host_store.HostReplayStore(3, 2)
    assert again.load(tmp_path / "ring.bin") == 4
    np.testing.assert_array_equal(again.read(0, 4)[0], q)

    with pytest.raises(IOError):
        host_store.HostReplayStore(query_size=5, num_hands=2).load(ours)
    with pytest.raises(ValueError):
        store.append(np.zeros((1, 4)), np.zeros((1, 2)))


def test_host_store_builds_the_library_without_the_tracked_one(
        tmp_path, monkeypatch):
    """Without ``csrc/librebel_host.so`` the binding builds it from
    ``csrc/`` into its own directory and writes nothing into ``csrc/``."""
    csrc = sorted(p.name for p in refrng.SOURCE.parent.iterdir())
    monkeypatch.setattr(refrng, "CSRC_LIB", tmp_path / "absent.so")
    monkeypatch.setattr(refrng, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(refrng, "BUILT_LIB", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(host_store, "_lib", None)
    store = host_store.HostReplayStore(3, 2)
    store.append(*_rows(3))
    assert len(store) == 3
    assert (tmp_path / "build" / "lib.so").exists()
    assert sorted(p.name for p in refrng.SOURCE.parent.iterdir()) == csrc
