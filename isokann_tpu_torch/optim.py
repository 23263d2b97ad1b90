"""Optimisers for ISOKANN training; counterpart of ``isokann_tpu/optim.py``.

Both couple an L2 term to the gradient before the accelerator
(``WeightDecay(reg) |> Adam`` in the reference), which is what
``weight_decay`` means for ``torch.optim.Adam`` and ``SGD`` (not AdamW).
An instance is a recipe; calling it on parameters builds the optimiser.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamRegularized:
    adam: float = 1e-3
    reg: float = 1e-4

    def __call__(self, params) -> torch.optim.Optimizer:
        # capturable on the card: ``Iso`` captures its steps in a CUDA graph
        params = list(params)
        return torch.optim.Adam(params, lr=self.adam, weight_decay=self.reg,
                                capturable=any(p.is_cuda for p in params))


@dataclass(frozen=True)
class NesterovRegularized:
    """The reference's default optimiser: L2 then Nesterov momentum 0.9."""

    lr: float = 1e-3
    reg: float = 1e-4

    def __call__(self, params) -> torch.optim.Optimizer:
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9,
                               nesterov=True, weight_decay=self.reg)
