"""JAX chi-model parameters -> the port's ``state_dict``.

The JAX package keeps an MLP's parameters as a pytree
``{"layers": [{"w": (in, out), "b": (out,)}, ...],
"ln": {"gamma", "beta"}}``; ``nn.Linear`` stores ``weight`` as (out, in).
Its chi ensemble keeps the same pytree with a leading member axis E on
every leaf; ``ensemble.StackedMLP`` stores ``weights`` as (E, in, out)
and biases, gamma and beta as (E, 1, n).  Takes the pytrees with numpy
leaves, so this module needs no JAX."""

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


def stacked_state_dict_from_jax(params) -> dict:
    """A JAX ensemble's stacked parameters -> ``StackedMLP``'s
    ``state_dict``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    sd = {}
    for i, layer in enumerate(params["layers"]):
        sd[f"weights.{i}"] = t(layer["w"])
        sd[f"biases.{i}"] = t(layer["b"])[:, None, :]
    if "ln" in params:
        sd["gamma"] = t(params["ln"]["gamma"])[:, None, :]
        sd["beta"] = t(params["ln"]["beta"])[:, None, :]
    return sd


def load_jax_ensemble_params(ensemble, params):
    """Copy a JAX ``ChiEnsemble``'s stacked parameters into the port's
    ``ensemble`` (its ``StackedMLP``) in place; returns the ensemble."""
    model = ensemble.model
    sd = stacked_state_dict_from_jax(params)
    model.load_state_dict({k: v.to(model.weights[0].device)
                           for k, v in sd.items()})
    return ensemble
