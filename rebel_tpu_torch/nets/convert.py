"""Carry CFV-net weights between the flax ``CFVNet`` parameter tree and
the ``Net2`` state dict of :class:`rebel_tpu_torch.nets.cfv_net.CFVNet`.

Layout correspondence (flax kernels are ``[in, out]``, torch weights
``[out, in]``):

    ``body.{4k+0}`` Linear     <-> ``Dense_k`` (kernel = weight.T)
    ``body.{4k+1}`` LayerNorm  <-> ``LayerNorm_k`` (scale = weight)
    ``output``      Linear     <-> ``Dense_{n_layers}``

:func:`export_torchscript` writes a net as a TorchScript ``Net2``
archive, the reference's interchange format, which ``torch.jit.load``
reads without this package.
"""

from __future__ import annotations

import copy
import pickle

import numpy as np
import torch

from rebel_tpu_torch.games.liars_dice import LiarsDice
from rebel_tpu_torch.nets.cfv_net import CFVNet

STRIDE = 4  # [Linear, norm, act, dropout] per hidden layer


def _n_layers_flax(p: dict) -> int:
    return sum(1 for k in p if k.startswith("Dense_")) - 1


def from_flax(params: dict) -> dict:
    """``{"params": {"Dense_k": {kernel, bias}, "LayerNorm_k": {scale,
    bias}}}`` of numpy arrays -> a ``Net2`` state dict of CPU tensors."""
    p = params["params"]
    n_layers = _n_layers_flax(p)
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    sd = {}
    for k in range(n_layers):
        sd[f"body.{STRIDE * k}.weight"] = t(p[f"Dense_{k}"]["kernel"]).T
        sd[f"body.{STRIDE * k}.bias"] = t(p[f"Dense_{k}"]["bias"])
        if f"LayerNorm_{k}" in p:
            ln = p[f"LayerNorm_{k}"]
            sd[f"body.{STRIDE * k + 1}.weight"] = t(ln["scale"])
            sd[f"body.{STRIDE * k + 1}.bias"] = t(ln["bias"])
    sd["output.weight"] = t(p[f"Dense_{n_layers}"]["kernel"]).T
    sd["output.bias"] = t(p[f"Dense_{n_layers}"]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def to_flax(state_dict: dict) -> dict:
    """Inverse of :func:`from_flax`: a ``Net2`` state dict -> the flax
    parameter tree as float32 numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    n_layers = _n_layers_sd(sd)
    p: dict = {}
    for k in range(n_layers):
        p[f"Dense_{k}"] = {
            "kernel": sd[f"body.{STRIDE * k}.weight"].T.copy(),
            "bias": sd[f"body.{STRIDE * k}.bias"].copy(),
        }
        if f"body.{STRIDE * k + 1}.weight" in sd:
            p[f"LayerNorm_{k}"] = {
                "scale": sd[f"body.{STRIDE * k + 1}.weight"].copy(),
                "bias": sd[f"body.{STRIDE * k + 1}.bias"].copy(),
            }
    p[f"Dense_{n_layers}"] = {
        "kernel": sd["output.weight"].T.copy(),
        "bias": sd["output.bias"].copy(),
    }
    return {"params": p}


def _n_layers_sd(sd: dict) -> int:
    idx = [int(k.split(".")[1]) for k in sd
           if k.startswith("body.") and k.endswith(".weight")]
    return max(idx) // STRIDE + 1 if idx else 0


def net_from_state_dict(state_dict: dict, game: LiarsDice) -> CFVNet:
    """A :class:`CFVNet` whose sizes are read off a ``Net2`` state dict."""
    n_layers = _n_layers_sd(state_dict)
    net = CFVNet(
        game,
        n_hidden=state_dict["output.weight"].shape[1],
        n_layers=n_layers,
        use_layer_norm="body.1.weight" in state_dict,
    )
    net.load_state_dict(state_dict)
    return net


def save_net2(net: CFVNet, path) -> None:
    """Save as a plain ``Net2`` state dict (the reference checkpoint
    format)."""
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               path)


def load_net2(path, game: LiarsDice, device="cuda") -> CFVNet:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return net_from_state_dict(sd, game).to(device)


def load_flax_params(path) -> dict:
    """A ``.params`` export of the JAX trainer: a plain pickle of the flax
    parameter tree as numpy arrays (no JAX needed to read it).  Unpickling
    runs code from the file: load only checkpoints you trust, such as this
    repo's own under ``results/``."""
    with open(path, "rb") as f:
        params = pickle.load(f)
    if not (isinstance(params, dict) and "params" in params):
        raise ValueError(f"{path} is not a flax parameter export")
    return params


def load_params_net(path, game: LiarsDice, device="cuda") -> CFVNet:
    """The :class:`CFVNet` of a ``.params`` export, its sizes read off the
    arrays."""
    sd = from_flax(load_flax_params(path))
    return net_from_state_dict(sd, game).to(device)


class _Net2(torch.nn.Module):
    """The reference ``Net2``: ``output(body(packed_input))``."""

    def __init__(self, body: torch.nn.Module, output: torch.nn.Module):
        super().__init__()
        self.body = body
        self.output = output

    def forward(self, packed_input: torch.Tensor) -> torch.Tensor:
        return self.output(self.body(packed_input))


def export_torchscript(net: CFVNet, path) -> str:
    """Write ``net`` (in f32, on the CPU) as a TorchScript ``Net2`` archive
    at ``path``, the format the reference's evaluation binaries load;
    returns ``path``."""
    m = _Net2(copy.deepcopy(net.body), copy.deepcopy(net.output))
    m = m.to("cpu", torch.float32).eval()
    torch.jit.save(torch.jit.script(m), str(path))
    return str(path)
