"""Config and experiment layer of the run entry, the counterpart of
``rebel_tpu/config.py``: yaml configs with ``defaults:`` composition,
dotted ``key=value`` overrides, the mapping onto
:class:`~rebel_tpu_torch.training.trainer.TrainerConfig` (unknown keys
raise, known vestigial ones are accepted with a log line), experiment
directories keyed by config and overrides, and the run modes
``gentle_start``, ``start_restart``, ``start_continue``, ``restart`` and
``dryrun``.

Where the port differs: ``selfplay.engine: pallas`` is the port's
``kernel`` engine and ``selfplay.net_compute_dtype`` becomes a torch
dtype.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pathlib
import shutil
import time
from typing import Any

import torch
import yaml

from rebel_tpu_torch.selfplay.runner import RecursiveSolvingParams
from rebel_tpu_torch.solving.params import SubgameSolvingParams
from rebel_tpu_torch.training.trainer import TrainerConfig, checkpoints

log = logging.getLogger(__name__)

MODES = ("gentle_start", "start_restart", "start_continue", "restart",
         "dryrun")

# selfplay.engine values of the JAX package and the port's engine kinds.
ENGINES = {"auto": "auto", "pallas": "kernel", "kernel": "kernel",
           "fast": "fast", "batched": "batched", "generic": "generic"}


# ------------------------------------------------------------- yaml load
def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_yaml_config(path: str | pathlib.Path) -> dict:
    """Load a config with hydra-style ``defaults:`` composition: each
    entry ``{group: name}`` pulls ``<dir>/<group>/<name>.yaml`` (or
    ``<dir>/../common/<group>/<name>.yaml``) under that group; a plain
    entry ``name`` merges ``<dir>/<name>.yaml`` at the top."""
    path = pathlib.Path(path)
    raw = yaml.safe_load(path.read_text()) or {}
    cfg: dict = {}
    for entry in raw.pop("defaults", []) or []:
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            sub = path.parent / group / f"{name}.yaml"
            if not sub.exists():
                sub = path.parent.parent / "common" / group / f"{name}.yaml"
            _deep_update(cfg, {group: yaml.safe_load(sub.read_text()) or {}})
        else:
            sub = path.parent / f"{entry}.yaml"
            _deep_update(cfg, yaml.safe_load(sub.read_text()) or {})
    return _deep_update(cfg, raw)


def _coerce(value: str) -> Any:
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Dotted ``key=value`` overrides, values parsed as yaml."""
    for ov in overrides:
        key, _, value = ov.partition("=")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _coerce(value)
    return cfg


# ------------------------------------------------------- dataclass build
def _build(dc_type, data: dict, path: str = ""):
    fields = {f.name for f in dataclasses.fields(dc_type)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise ValueError(
                f"Unknown config key '{path}{k}' for {dc_type.__name__} "
                "(mirroring create_mdp_config's unknown-key error, "
                "cfvpy/selfplay.py:597-606)"
            )
        if isinstance(v, dict):
            sub_type = {"env": RecursiveSolvingParams,
                        "subgame_params": SubgameSolvingParams}.get(k)
            if sub_type is None:
                raise ValueError(f"Unexpected nested config at '{path}{k}'")
            kwargs[k] = _build(sub_type, v, f"{path}{k}.")
        else:
            kwargs[k] = v
    return dc_type(**kwargs)


def _check_section(section: str, d: dict, consumed, vestigial=()):
    """Unknown keys inside a consumed section raise (a typo such as
    ``optimizer.lr_`` must fail loudly); known vestigial keys of the
    reference configs are accepted with a log line."""
    extra = set(d) - set(consumed) - set(vestigial)
    if extra:
        raise ValueError(f"Unknown config keys in {section}: {sorted(extra)}")
    for k in sorted(set(d) & set(vestigial)):
        log.info("config key '%s.%s' accepted but unused in rebel_tpu",
                 section, k)


def _engine(name: str) -> str:
    if name not in ENGINES:
        raise ValueError(f"Unknown selfplay.engine {name!r}; one of "
                         f"{sorted(ENGINES)}")
    return ENGINES[name]


def cfg_to_trainer_config(cfg: dict) -> TrainerConfig:
    """Map the reference's yaml layout onto :class:`TrainerConfig`."""
    c = dict(cfg)  # shallow copy; consume known sections
    out: dict[str, Any] = {}
    env = c.pop("env", {})
    if env:
        out["env"] = _build(RecursiveSolvingParams, env, "env.")
    model = c.pop("model", {})
    if model:
        _check_section("model", model, {"kwargs"}, {"name", "classname"})
        kwargs = model.get("kwargs", {})
        _check_section("model.kwargs", kwargs,
                       {"n_hidden", "n_layers", "use_layer_norm"},
                       {"dropout"})
        out["n_hidden"] = kwargs.get("n_hidden", 256)
        out["n_layers"] = kwargs.get("n_layers", 2)
        out["use_layer_norm"] = kwargs.get("use_layer_norm", True)
    opt = c.pop("optimizer", {})
    if opt:
        _check_section("optimizer", opt,
                       {"kwargs", "classname", "name", "lr", "momentum"})
        kwargs = opt.get("kwargs", {})
        _check_section("optimizer.kwargs", kwargs, {"lr", "momentum"},
                       {"eps", "betas", "weight_decay"})
        # A direct override (optimizer.lr=...) beats the defaults file's
        # kwargs.lr.
        out["lr"] = opt.get("lr", kwargs.get("lr", 3e-4))
        cls = opt.get("classname", opt.get("name"))
        if cls:
            out["optimizer"] = str(cls).rsplit(".", 1)[-1].lower()
        if "momentum" in opt or "momentum" in kwargs:
            out["momentum"] = opt.get("momentum", kwargs.get("momentum"))
    data = c.pop("data", {})
    if data:
        _check_section("data", data, {"train_epoch_size", "train_batch_size"})
        out["train_epoch_size"] = data.get("train_epoch_size", 25600)
        out["train_batch_size"] = data.get("train_batch_size", 512)
    replay = c.pop("replay", {})
    if replay:
        _check_section("replay", replay,
                       {"capacity", "alpha", "beta", "use_priority"},
                       {"prefetch"})
        out["replay_capacity"] = int(replay.get("capacity", 2_000_000))
        out["replay_alpha"] = replay.get("alpha", 1.0)
        out["replay_beta"] = replay.get("beta", 1.0)
        out["use_priority"] = replay.get("use_priority", False)
    selfplay = c.pop("selfplay", {})
    if selfplay:
        _check_section(
            "selfplay", selfplay,
            {"batch", "cpu_gen_threads", "engine", "net_compute_dtype",
             "dump_dataset_every_epochs"},
            {"network_sync_epochs", "threads_per_gpu", "models_per_gpu"},
        )
        out["selfplay_batch"] = selfplay.get(
            "batch", selfplay.get("cpu_gen_threads", 60) * 16)
        if "engine" in selfplay:
            out["engine"] = _engine(selfplay["engine"])
        if "net_compute_dtype" in selfplay:
            name = {"bf16": "bfloat16", "f32": "float32"}.get(
                selfplay["net_compute_dtype"], selfplay["net_compute_dtype"])
            out["net_compute_dtype"] = getattr(torch, name)
        if "dump_dataset_every_epochs" in selfplay:
            out["dump_dataset_every_epochs"] = selfplay[
                "dump_dataset_every_epochs"]
    direct = {
        "seed", "decrease_lr_every", "decrease_lr_times", "grad_clip",
        "loss", "train_gen_ratio", "max_epochs", "exploit", "exploit_every",
        "eval_mse", "eval_num_repeats", "checkpoint_every",
        "keep_checkpoints", "create_validation_set_every",
        "dump_dataset_every_epochs", "purging_epochs", "purging_share_keep",
        "train_preload", "stall_timeout_s", "benchmark_data_gen",
        "fake_training",
    }
    for k in list(c):
        if k in direct:
            out[k] = c.pop(k)
    # Reference keys that do not map onto the fused design (vestigial:
    # min_buffer_to_send is unused even in the reference).
    for k in list(c):
        if k in {"task", "min_buffer_to_send", "show_progress_bar",
                 "train_policy"}:
            log.info("config key '%s' accepted but unused in rebel_tpu", k)
            c.pop(k)
    if c:
        raise ValueError(f"Unknown config keys: {sorted(c)}")
    return TrainerConfig(**out)


# --------------------------------------------------------- experiments
def exp_dir_for(cfg_path: str, overrides: list[str], root: str = "outputs",
                adhoc: bool = False) -> pathlib.Path:
    """Experiment dir keyed by config + sorted overrides; ``adhoc`` adds a
    content hash salted with the time, so reruns get fresh dirs."""
    name = pathlib.Path(cfg_path).stem
    parts = [ov.replace("/", "_") for ov in sorted(overrides)]
    key = "-".join(parts) if parts else "default"
    if len(key) > 120 or adhoc:
        payload = [cfg_path, sorted(overrides)]
        if adhoc:
            payload.append(time.time_ns())  # fresh dir per adhoc run
        h = hashlib.sha1(json.dumps(payload).encode()).hexdigest()[:8]
        key = f"{key[:80]}-{h}" if not adhoc else f"adhoc-{h}-{key[:60]}"
    return pathlib.Path(root) / name / key


def exp_status(exp_dir: pathlib.Path) -> str:
    """NOT_STARTED / RUNNING / DONE / DEAD, with liveness read off the
    ``heartbeat`` file's age."""
    if not exp_dir.exists():
        return "NOT_STARTED"
    if (exp_dir / "result.json").exists():
        return "DONE"
    hb = exp_dir / "heartbeat"
    if hb.exists():
        if time.time() - hb.stat().st_mtime < 300:
            return "RUNNING"
        return "DEAD"
    return "DEAD" if any(exp_dir.iterdir()) else "NOT_STARTED"


def handle_dst(exp_dir: pathlib.Path, mode: str) -> bool:
    """Decide whether to (re)run; may wipe the dir.  Returns True when the
    caller should proceed with the run."""
    status = exp_status(exp_dir)
    log.info("Experiment dir %s status=%s mode=%s", exp_dir, status, mode)
    if mode == "dryrun":
        return False
    if mode == "gentle_start":
        if status in ("RUNNING", "DONE"):
            log.info("Already %s; not starting (gentle_start)", status)
            return False
        if status == "DEAD":
            shutil.rmtree(exp_dir)
    elif mode == "start_restart":
        if status == "RUNNING":
            return False
        if status in ("DEAD", "DONE"):
            shutil.rmtree(exp_dir)
    elif mode == "restart":
        if exp_dir.exists():
            shutil.rmtree(exp_dir)
    elif mode == "start_continue":
        pass  # resume from the latest checkpoint if present
    else:
        raise ValueError(f"Unknown mode {mode}; choose from {MODES}")
    exp_dir.mkdir(parents=True, exist_ok=True)
    return True


def latest_checkpoint(exp_dir: pathlib.Path) -> pathlib.Path | None:
    """Newest full-state checkpoint ``ckpt/epoch<N>.ckpt``."""
    ckpts = checkpoints(exp_dir / "ckpt")
    return ckpts[-1] if ckpts else None
