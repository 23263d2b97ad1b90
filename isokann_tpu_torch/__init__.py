"""PyTorch + CUDA port of ``isokann_tpu`` for one NVIDIA H100.

The JAX package ``isokann_tpu`` is the reference; each module here keeps
its counterpart's name.  Entry points take an explicit ``device`` that
defaults to ``"cuda"`` and raise when no GPU is present; tests pass
``device="cpu"``, which runs the plain PyTorch version of every kernel.
Every random draw on the host comes from an explicit ``torch.Generator``.

Float32 throughout, with TF32 off: coordinate matmuls run at full
precision (the Hopper form of the reference's HIGHEST-precision rule).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._device import make_generator, resolve_device  # noqa: E402
from .data import SimulationData, WeightedSamples  # noqa: E402
from .features import (FeaturesAll, FeaturesAngles,  # noqa: E402
                       FeaturesAtoms, FeaturesCoords, FeaturesPairs,
                       FeaturesRandomPairs)
from .iso import Iso  # noqa: E402
from .md.integrators import optcontrol  # noqa: E402
from .models import MLP, autonet, pairnet  # noqa: E402
from .optim import AdamRegularized, NesterovRegularized  # noqa: E402
from .simulators.mdsim import MDSimulation  # noqa: E402
from .targets import (DomainError, TransformShiftscale,  # noqa: E402
                      expectation, shiftscale)
from .workflows import run_girsanov  # noqa: E402

__all__ = [
    "AdamRegularized", "DomainError", "FeaturesAll", "FeaturesAngles",
    "FeaturesAtoms", "FeaturesCoords", "FeaturesPairs",
    "FeaturesRandomPairs", "Iso", "MDSimulation",
    "MLP", "NesterovRegularized", "SimulationData",
    "TransformShiftscale", "WeightedSamples", "autonet", "expectation",
    "make_generator", "optcontrol", "pairnet", "resolve_device",
    "run_girsanov", "shiftscale",
]
