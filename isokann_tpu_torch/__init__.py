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
from .iso import (FunctionLogger, Iso, ValidationLogger,  # noqa: E402
                  ValidationLossLogger, load, save, validationloss)
from .md.integrators import optcontrol  # noqa: E402
from .models import MLP, autonet, growmodel, pairnet  # noqa: E402
from .optim import AdamRegularized, NesterovRegularized  # noqa: E402
from .simulators.langevin import (Diffusion, Doublewell,  # noqa: E402
                                  MuellerBrown, Triplewell)
from .simulators.mdsim import MDSimulation  # noqa: E402
from .targets import (DomainError, Stabilize, TransformCross,  # noqa: E402
                      TransformGramSchmidt, TransformISA,
                      TransformLeftRight, TransformLeftRightHistory,
                      TransformPinv, TransformPseudoInv, TransformShiftscale,
                      TransformSVD, TransformSVDRev, expectation, isotarget,
                      shiftscale)
from .workflows import run_girsanov  # noqa: E402

__all__ = [
    "AdamRegularized", "Diffusion", "DomainError", "Doublewell",
    "FeaturesAll", "FeaturesAngles", "FeaturesAtoms", "FeaturesCoords",
    "FeaturesPairs", "FeaturesRandomPairs", "FunctionLogger", "Iso",
    "MDSimulation", "MLP", "MuellerBrown", "NesterovRegularized",
    "SimulationData", "Stabilize", "TransformCross", "TransformGramSchmidt",
    "TransformISA", "TransformLeftRight", "TransformLeftRightHistory",
    "TransformPinv", "TransformPseudoInv", "TransformSVD",
    "TransformSVDRev", "TransformShiftscale", "Triplewell",
    "ValidationLogger", "ValidationLossLogger", "WeightedSamples",
    "autonet", "expectation", "growmodel", "isotarget", "load",
    "make_generator", "optcontrol", "pairnet", "resolve_device",
    "run_girsanov", "save", "shiftscale", "validationloss",
]
