"""Fixed-seed episode replication in the port against the reference C++.

``rebel_tpu_torch.selfplay.replicate.replicate_episodes`` drives the
port's batch-first solver with the reference's ``std::mt19937`` stream and
must reproduce the training examples that the reference implementation
recorded in ``tests/golden/episodes_*_1x4.json``, as
``tests/test_episode_parity.py`` holds the JAX package: fictitious play
bit for bit, CFR to atol 1e-5 (queries) and 1e-4 (values).  Also: the
port's binding of the stream draws what the JAX package's does, and it
builds ``csrc/refrng.cc`` itself where the tracked library is absent.
"""

import json
import pathlib

import numpy as np
import pytest

from rebel_tpu.selfplay.host_store import ReferenceRng as JReferenceRng

from rebel_tpu_torch.selfplay import refrng
from rebel_tpu_torch.selfplay.replicate import replicate_episodes
from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
from rebel_tpu_torch.solving.params import SubgameSolvingParams

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(autouse=True)
def one_thread():
    """One subgame at a time: one thread, so that the test workers running
    side by side do not wait for each other's threads."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("fixture,bitexact", [
    ("episodes_fp_1x4.json", True),
    ("episodes_fp_single_1x4.json", True),
    ("episodes_cfr_1x4.json", False),
])
def test_episode_replication(fixture, bitexact):
    g = json.loads((GOLDEN / fixture).read_text())
    cfg = RecursiveSolvingParams(
        num_dice=1, num_faces=4,
        subgame_params=SubgameSolvingParams(
            num_iters=g["num_iters"], max_depth=2, linear_update=True,
            use_cfr=bool(g["use_cfr"])),
        random_action_prob=0.25, sample_leaf=bool(g["sample_leaf"]))
    mine = replicate_episodes(cfg, seed=g["seed"], episodes=g["episodes"])
    assert len(mine) == len(g["queries"]) == len(g["values"])
    for i, (ex, q, v) in enumerate(zip(mine, g["queries"], g["values"])):
        q, v = np.array(q, np.float32), np.array(v, np.float32)
        if bitexact:
            np.testing.assert_array_equal(ex.query, q, err_msg=f"q{i}")
            np.testing.assert_array_equal(ex.values, v, err_msg=f"v{i}")
        else:
            np.testing.assert_allclose(ex.query, q, atol=1e-5)
            np.testing.assert_allclose(ex.values, v, atol=1e-4)


def _draws(rng):
    return ([rng.raw() for _ in range(3)]
            + [rng.uniform_int(0, 1024), rng.uniform_int(3, 5)]
            + [rng.uniform_float() for _ in range(3)]
            + [rng.discrete([0.1, 0.0, 0.7, 0.2]) for _ in range(5)])


def test_reference_rng_draws_what_the_jax_package_draws():
    assert _draws(refrng.ReferenceRng(777)) == _draws(JReferenceRng(777))


def test_reference_rng_builds_the_source_without_the_tracked_library(
        tmp_path, monkeypatch):
    """Without ``csrc/librebel_host.so`` the binding compiles
    ``csrc/refrng.cc`` into its own build directory, and writes nothing
    into ``csrc/``."""
    csrc = sorted(p.name for p in refrng.SOURCE.parent.iterdir())
    monkeypatch.setattr(refrng, "CSRC_LIB", tmp_path / "absent.so")
    monkeypatch.setattr(refrng, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(refrng, "BUILT_LIB", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(refrng, "_lib", None)
    assert refrng.library_path() == tmp_path / "build" / "lib.so"
    assert _draws(refrng.ReferenceRng(5)) == _draws(JReferenceRng(5))
    assert sorted(p.name for p in refrng.SOURCE.parent.iterdir()) == csrc
