"""Chi models as ``nn.Module``s; counterpart of ``isokann_tpu/models.py``.

``MLP``: optional input LayerNorm (eps 1e-5, Flux semantics), dense
layers with Glorot-uniform weights and zero biases, ``activation`` on the
hidden layers and ``lastactivation`` on the output.  Inputs are
(..., features), outputs (..., nout).  A model built with ``device`` on
the card draws its weights there (see ``MLP.reset_parameters``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ._device import draw_seed, make_generator

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


class MLP(nn.Module):
    def __init__(self, sizes: Sequence[int], activation: str = "sigmoid",
                 lastactivation: str = "identity", layernorm: bool = False,
                 gen=None, device=None):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        self.activation = activation
        self.lastactivation = lastactivation
        self.layernorm = bool(layernorm)
        self.ln = (nn.LayerNorm(self.sizes[0], eps=1e-5, device=device)
                   if layernorm else None)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device)
            for a, b in zip(self.sizes[:-1], self.sizes[1:]))
        self.reset_parameters(make_generator(gen))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """Glorot-uniform weights (Flux's Dense default), zero biases.
        The uniform draws come from ``gen`` for a model on the CPU; on the
        card from a CUDA generator seeded by one draw of ``gen``, so that
        a model of 10^8 weights and more (all-pairs features of a
        protein) is neither drawn on the host nor copied to the card."""
        device = self.layers[0].weight.device
        if device.type != "cpu":
            g = torch.Generator(device=device)
            g.manual_seed(draw_seed(gen))
            gen = g
        for layer in self.layers:
            fan_out, fan_in = layer.weight.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            w = torch.rand((fan_in, fan_out), generator=gen,
                           device=device) * 2 - 1
            layer.weight.copy_((w * limit).T)
            layer.bias.zero_()

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        lastact = ACTIVATIONS[self.lastactivation]
        if self.ln is not None:
            x = self.ln(x)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            x = lastact(x) if i == len(self.layers) - 1 else act(x)
        return x

    @property
    def inputdim(self) -> int:
        return self.sizes[0]

    @property
    def outputdim(self) -> int:
        return self.sizes[-1]


def densenet(layers: Sequence[int], activation="sigmoid",
             lastactivation="identity", layernorm=False, gen=None,
             device=None) -> MLP:
    return MLP(layers, activation, lastactivation, layernorm, gen, device)


def pairnet(n: int, layers: int = 3, activation="sigmoid",
            lastactivation="identity", nout: int = 1, layernorm: bool = True,
            gen=None, device=None) -> MLP:
    """Default chi MLP with geometric width decay n^(l/L)."""
    sizes = [round(n ** (l / layers)) for l in range(layers, 0, -1)] + [nout]
    return densenet(sizes, activation, lastactivation, layernorm, gen, device)


def smallnet(nin: int, nout: int = 1, activation="sigmoid",
             lastactivation="identity", gen=None, device=None) -> MLP:
    """3x8-unit MLP for low-dimensional inputs."""
    return densenet([nin, 8, 8, 8, nout], activation, lastactivation, False,
                    gen, device)


def autonet(n: int, nout: int = 1, gen=None, device=None, **kwargs) -> MLP:
    """smallnet below 16 features, pairnet from 16 up."""
    if n < 16:
        return smallnet(n, nout=nout, gen=gen, device=device)
    return pairnet(n=n, nout=nout, gen=gen, device=device, **kwargs)


def growmodel(model: MLP, n: int, gen=None) -> MLP:
    """A copy of ``model`` with ``n`` outputs: every layer but the last
    and the LayerNorm keep their trained weights; the last layer is drawn
    anew (Glorot-uniform from ``gen``, zero bias)."""
    device = model.layers[0].weight.device
    new = MLP(model.sizes[:-1] + (n,), model.activation,
              model.lastactivation, model.layernorm, gen=gen, device=device)
    with torch.no_grad():
        for src, dst in zip(model.layers[:-1], new.layers[:-1]):
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
        if model.ln is not None:
            new.ln.load_state_dict(model.ln.state_dict())
    return new
