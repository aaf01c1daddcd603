"""The port's config and experiment layer (``rebel_tpu_torch/config.py``)
against the JAX package's ``rebel_tpu/config.py``: the same yaml loading
and overrides, the same ``TrainerConfig`` fields for ``conf/liars_sp.yaml``
with each optimizer file and the round-5 overrides (dtypes by name; the
JAX package's ``pallas`` engine is the port's ``kernel``), the same errors
on unknown keys, the same experiment dirs and run-mode decisions."""

import dataclasses
import os
import pathlib
import time

import pytest
import torch
import yaml

from rebel_tpu import config as jcfg
from rebel_tpu.training.trainer import TrainerConfig as JTrainerConfig

from rebel_tpu_torch import config as cfglib
from rebel_tpu_torch.training.trainer import TrainerConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
CONF = REPO / "conf" / "liars_sp.yaml"
# scripts/round5_run.sh: the overrides every round-5 net was trained with.
ROUND5 = ["exploit_every=200", "max_epochs=1000", "selfplay.batch=2048",
          "selfplay.engine=pallas", "selfplay.net_compute_dtype=bf16",
          "stall_timeout_s=1800", "env.subgame_params.use_cfr=true"]


def plain(value):
    """A config value with dtypes by name and dataclasses as dicts."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type):  # jnp.float32, jnp.bfloat16
        return value.__name__
    return value


def loaded(pkg, optimizer, overrides):
    cfg = pkg.load_yaml_config(CONF)
    cfg["optimizer"] = yaml.safe_load(
        (REPO / "conf" / "optimizer" / f"{optimizer}.yaml").read_text())
    return pkg.apply_overrides(cfg, list(overrides))


@pytest.mark.parametrize("overrides", [[], ROUND5], ids=["conf", "round5"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd", "radam", "ralamb"])
def test_trainer_config_equals_jax(optimizer, overrides):
    cfg, jc = loaded(cfglib, optimizer, overrides), loaded(jcfg, optimizer,
                                                          overrides)
    assert cfg == jc
    got = plain(cfglib.cfg_to_trainer_config(cfg))
    want = plain(jcfg.cfg_to_trainer_config(jc))
    if want["engine"] == "pallas":
        want["engine"] = "kernel"
    assert [f.name for f in dataclasses.fields(TrainerConfig)] == \
        [f.name for f in dataclasses.fields(JTrainerConfig)]
    assert got == want
    assert got["optimizer"] == optimizer


def test_defaults_composition_and_overrides(tmp_path):
    """``defaults:`` from ``<dir>/<group>`` and from ``../common/<group>``,
    a plain default merged at the top, dotted overrides parsed as yaml."""
    (tmp_path / "common" / "optimizer").mkdir(parents=True)
    (tmp_path / "common" / "optimizer" / "sgd.yaml").write_text(
        "classname: SGD\nkwargs:\n  lr: 0.01\n")
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "base.yaml").write_text("seed: 3\nloss: mse\n")
    (tmp_path / "c" / "main.yaml").write_text(
        "defaults:\n  - optimizer: sgd\n  - base\nseed: 5\nenv:\n"
        "  num_faces: 3\n")
    ov = ["env.num_faces=2", "optimizer.lr=0.5", "purging_epochs=[2, 4]",
          "train_preload=null", "env.subgame_params.use_cfr=true"]
    cfg = cfglib.apply_overrides(
        cfglib.load_yaml_config(tmp_path / "c" / "main.yaml"), ov)
    jc = jcfg.apply_overrides(
        jcfg.load_yaml_config(tmp_path / "c" / "main.yaml"), ov)
    assert cfg == jc
    assert cfg["seed"] == 5 and cfg["loss"] == "mse"
    tc = cfglib.cfg_to_trainer_config(cfg)
    assert (tc.optimizer, tc.lr, tc.purging_epochs) == ("sgd", 0.5, [2, 4])


@pytest.mark.parametrize("bad", [
    {"bogus": 1},
    {"optimizer": {"lr_": 1}},
    {"optimizer": {"kwargs": {"beta1": 0.9}}},
    {"model": {"kwargs": {"n_hiden": 3}}},
    {"model": {"foo": 1}},
    {"env": {"num_dies": 1}},
    {"env": {"subgame_params": {"iters": 3}}},
    {"env": {"num_dice": {"a": 1}}},
    {"data": {"train_size": 1}},
    {"replay": {"cap": 1}},
    {"selfplay": {"engines": "x"}},
], ids=lambda d: str(d))
def test_unknown_keys_raise_as_in_jax(bad):
    with pytest.raises(ValueError) as want:
        jcfg.cfg_to_trainer_config(bad)
    with pytest.raises(ValueError) as got:
        cfglib.cfg_to_trainer_config(bad)
    assert str(got.value) == str(want.value)


def test_vestigial_keys_are_accepted_and_engines_map():
    cfg = {"task": "selfplay", "min_buffer_to_send": 2500,
           "replay": {"prefetch": 8},
           "selfplay": {"network_sync_epochs": 1, "cpu_gen_threads": 2},
           "model": {"name": "Net2", "kwargs": {"dropout": 0}}}
    tc = cfglib.cfg_to_trainer_config(cfg)
    assert tc.selfplay_batch == 32 == jcfg.cfg_to_trainer_config(
        cfg).selfplay_batch
    for name, kind in (("pallas", "kernel"), ("kernel", "kernel"),
                       ("auto", "auto"), ("fast", "fast"),
                       ("batched", "batched"), ("generic", "generic")):
        assert cfglib.cfg_to_trainer_config(
            {"selfplay": {"engine": name}}).engine == kind
    with pytest.raises(ValueError, match="selfplay.engine"):
        cfglib.cfg_to_trainer_config({"selfplay": {"engine": "warp"}})


@pytest.mark.parametrize("overrides", [
    [], ["max_epochs=2"], ["b=1", "a/b=2", "env.num_faces=3"],
    [f"key{i}=value{i}" for i in range(20)],
], ids=["none", "one", "sorted", "long"])
def test_exp_dir_for_equals_jax(overrides):
    assert cfglib.exp_dir_for("conf/liars_sp.yaml", overrides, "out") == \
        jcfg.exp_dir_for("conf/liars_sp.yaml", overrides, "out")
    adhoc = cfglib.exp_dir_for("conf/liars_sp.yaml", overrides, "out",
                               adhoc=True)
    jadhoc = jcfg.exp_dir_for("conf/liars_sp.yaml", overrides, "out",
                              adhoc=True)
    assert adhoc.parent == jadhoc.parent
    assert adhoc.name.startswith("adhoc-") and len(adhoc.name) == \
        len(jadhoc.name)


def make_dir(root: pathlib.Path, status: str) -> pathlib.Path:
    d = root / status
    if status == "NOT_STARTED":
        return d
    d.mkdir(parents=True)
    (d / "ckpt").mkdir()
    (d / "ckpt" / "epoch3.ckpt").write_bytes(b"x")
    (d / "ckpt" / "epoch12.ckpt").write_bytes(b"x")
    (d / "ckpt" / "epoch20.spmd.ckpt").write_bytes(b"x")
    if status == "DONE":
        (d / "result.json").write_text("{}")
    if status in ("RUNNING", "DEAD"):
        (d / "heartbeat").touch()
    if status == "DEAD":
        old = time.time() - 1000
        os.utime(d / "heartbeat", (old, old))
    return d


@pytest.mark.parametrize("mode", cfglib.MODES)
@pytest.mark.parametrize("status", ["NOT_STARTED", "RUNNING", "DONE",
                                    "DEAD"])
def test_handle_dst_equals_jax(tmp_path, mode, status):
    mine = make_dir(tmp_path / "port", status)
    theirs = make_dir(tmp_path / "jax", status)
    assert cfglib.exp_status(mine) == jcfg.exp_status(theirs) == status
    assert cfglib.handle_dst(mine, mode) == jcfg.handle_dst(theirs, mode)
    listing = lambda d: sorted(p.relative_to(d).as_posix()
                               for p in d.rglob("*")) if d.exists() else None
    assert listing(mine) == listing(theirs)
    got, want = (cfglib.latest_checkpoint(mine),
                 jcfg.latest_checkpoint(theirs))
    assert (got and got.name) == (want and want.name)
