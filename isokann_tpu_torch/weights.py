"""JAX chi-model parameters -> the port's ``state_dict``.

The JAX package keeps an MLP's parameters as a pytree
``{"layers": [{"w": (in, out), "b": (out,)}, ...],
"ln": {"gamma", "beta"}}``; ``nn.Linear`` stores ``weight`` as (out, in).
Takes the pytree with numpy leaves, so this module needs no JAX."""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params) -> dict:
    sd = {}
    for i, layer in enumerate(params["layers"]):
        sd[f"layers.{i}.weight"] = torch.as_tensor(
            np.asarray(layer["w"], np.float32).T.copy())
        sd[f"layers.{i}.bias"] = torch.tensor(
            np.asarray(layer["b"], np.float32))
    if "ln" in params:
        sd["ln.weight"] = torch.tensor(
            np.asarray(params["ln"]["gamma"], np.float32))
        sd["ln.bias"] = torch.tensor(
            np.asarray(params["ln"]["beta"], np.float32))
    return sd


def load_jax_params(model, params):
    """Copy JAX parameters into ``model`` in place; returns the model."""
    model.load_state_dict(state_dict_from_jax(params))
    return model
