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
from .analysis import (constrained_free_energy,  # noqa: E402
                       marginal_free_energy, mutual_information,
                       reactionpath_minimum, reactionpath_ode,
                       reactive_path, save_reactive_path, solve_committor)
from .data import (SimulationData, WeightedSamples, addcoords,  # noqa: E402
                   bootstrap, data_from_trajectories, data_from_trajectory,
                   exportdata, exportsorted, flattenfirst, flattenlast,
                   mergedata, resample_kde, resample_strat, subsample,
                   subsample_inds, subsample_random, to_device,
                   trajectorydata_bursts, trajectorydata_linear)
from .ensemble import ChiEnsemble, resample_uncertainty  # noqa: E402
from .features import (FeaturesAll, FeaturesAngles,  # noqa: E402
                       FeaturesAtoms, FeaturesCoords, FeaturesPairs,
                       FeaturesRandomPairs)
from .iso import (FunctionLogger, Iso, ValidationLogger,  # noqa: E402
                  ValidationLossLogger, chi_exit_rate, chicoords, chis,
                  load, rates, run, run_kde, save, simulationtime,
                  validationloss)
from .md.fixtures import alanine_dipeptide_pdb  # noqa: E402
from .md.integrators import optcontrol  # noqa: E402
from .models import (MLP, autonet, densenet, growmodel,  # noqa: E402
                     pairnet, smallnet)
from .ops.align import (align, aligned_rmsd, aligntrajectory,  # noqa: E402
                        pairwise_aligned_rmsd)
from .ops.dihedrals import dihedral  # noqa: E402
from .ops.pairdists import (flatpairdists, localpdistinds,  # noqa: E402
                            pairdist, pdists, restricted_localpdistinds,
                            sqpairdist)
from .optim import AdamRegularized, NesterovRegularized  # noqa: E402
from .sample import (addextrapolates, dchidx, extrapolate,  # noqa: E402
                     kde_needles, pickclosest, picking, picking_aligned,
                     resample_kde_ash, subsample_uniformgrid)
from .simulators.base import ExternalSimulation, IsoSimulation  # noqa: E402
from .simulators.bridge import (GuidedLangevinBridge,  # noqa: E402
                                LinearInterpolant, bridge_simplex,
                                resample_picking_features, run_bridges)
from .simulators.effective import (EffectiveSimulation,  # noqa: E402
                                   KDEExpectation)
from .simulators.langevin import (Diffusion, Doublewell,  # noqa: E402
                                  MuellerBrown, Triplewell)
from .simulators.mdsim import MDSimulation  # noqa: E402
from .simulators.metadynamics import (MetadynamicsSimulation,  # noqa: E402
                                      MetadynamicsState,
                                      MetadynamicsStateGridded)
from .targets import (DomainError, Stabilize, TransformCross,  # noqa: E402
                      TransformGramSchmidt, TransformISA,
                      TransformLeftRight, TransformLeftRightHistory,
                      TransformPinv, TransformPseudoInv, TransformShiftscale,
                      TransformSVD, TransformSVDRev, expectation, isotarget,
                      koopman, residual_linear, residual_ritz,
                      residual_subspace, shiftscale)
from . import parallel  # noqa: E402
from .workflows import (adaptive_metadynamics, cktest,  # noqa: E402
                        escalate_lag, lag_sweep, rates_resolved, run_both,
                        run_girsanov, run_kde_dash, run_metadynamics,
                        training_lag_headroom)
from .utils import (LazyMultiTrajectory, LazyTrajectory,  # noqa: E402
                    ReactionCoordsRMSD, autoplot, ca_rmsd, interactive_gui,
                    livegui, load_trajectory, phi_psi, plot_chi,
                    plot_training, save_trajectory, savecoords,
                    saveextrema, scatter_ramachandran, serve_dashboard,
                    standardform)
# the reference re-exports its OpenMM wrapper module (src/ISOKANN.jl:56);
# the counterpart here is the MD simulation module
from .simulators import mdsim as OpenMM  # noqa: E402

__version__ = "0.1.0"

# the reference's name of its MD simulation
OpenMMSimulation = MDSimulation


def propagate(sim, xs, nk, gen=None):
    """``sim.propagate(xs, nk, gen=gen)``."""
    return sim.propagate(xs, nk, gen=gen)


def trajectory(sim, *args, **kwargs):
    """``sim.trajectory(...)``."""
    return sim.trajectory(*args, **kwargs)


def laggedtrajectory(sim_or_data, n, **kwargs):
    """``.laggedtrajectory(n, ...)`` of a simulation or a dataset."""
    return sim_or_data.laggedtrajectory(n, **kwargs)


def cpu(tree):
    """A nested structure of tensors with every tensor on the host."""
    return to_device(tree, "cpu")


def device(tree, dev=None):
    """A nested structure of tensors with every tensor on ``dev`` (the
    card unless the caller names another)."""
    return to_device(tree, resolve_device(dev))


gpu = device


def readchemfile(path, frame=None):
    """A trajectory file (.npy, .pdb, .dcd) as a host (frames, 3N) array
    [nm], or its frame ``frame`` (the reference's chemfiles reader)."""
    traj = load_trajectory(path)
    return traj if frame is None else traj[frame]


def writechemfile(path, traj, top=None):
    """Write ``traj`` (frames, 3N) [nm] to a trajectory file (.npy, .pdb
    with ``top``, .dcd); returns ``path`` (the reference's chemfiles
    writer)."""
    return save_trajectory(path, traj, top=top)


def atom_indices(pdb: str, selector: str = "all"):
    """Atom indices of a PDB file for a selector: "all", "heavy",
    "name CA" / "calpha" or "backbone"."""
    from .features import _select_atoms
    from .md.pdbio import read_pdb
    return _select_atoms(read_pdb(pdb), selector)


__all__ = [
    "AdamRegularized", "ChiEnsemble", "Diffusion", "DomainError", "Doublewell",
    "EffectiveSimulation", "ExternalSimulation", "FeaturesAll",
    "FeaturesAngles", "FeaturesAtoms", "FeaturesCoords", "FeaturesPairs",
    "FeaturesRandomPairs", "FunctionLogger", "GuidedLangevinBridge", "Iso",
    "IsoSimulation", "KDEExpectation", "LazyMultiTrajectory", "LazyTrajectory",
    "LinearInterpolant", "MDSimulation", "MLP", "MetadynamicsSimulation",
    "MetadynamicsState", "MetadynamicsStateGridded", "MuellerBrown",
    "NesterovRegularized", "OpenMM", "OpenMMSimulation", "ReactionCoordsRMSD",
    "SimulationData", "Stabilize", "TransformCross", "TransformGramSchmidt",
    "TransformISA", "TransformLeftRight", "TransformLeftRightHistory",
    "TransformPinv", "TransformPseudoInv", "TransformSVD", "TransformSVDRev",
    "TransformShiftscale", "Triplewell", "ValidationLogger",
    "ValidationLossLogger", "WeightedSamples", "adaptive_metadynamics",
    "addcoords", "addextrapolates", "alanine_dipeptide_pdb", "align",
    "aligned_rmsd", "aligntrajectory", "atom_indices", "autonet", "autoplot",
    "bootstrap", "bridge_simplex", "ca_rmsd", "chi_exit_rate", "chicoords",
    "chis", "cktest", "constrained_free_energy", "cpu",
    "data_from_trajectories", "data_from_trajectory", "dchidx", "densenet",
    "device", "dihedral", "escalate_lag", "expectation", "exportdata",
    "exportsorted", "extrapolate", "flatpairdists", "flattenfirst",
    "flattenlast", "gpu", "growmodel", "interactive_gui", "isotarget",
    "kde_needles", "koopman", "lag_sweep", "laggedtrajectory", "livegui",
    "load", "load_trajectory", "localpdistinds", "make_generator",
    "marginal_free_energy", "mergedata", "mutual_information", "optcontrol",
    "pairdist", "pairnet", "pairwise_aligned_rmsd", "pdists", "phi_psi",
    "pickclosest", "picking", "picking_aligned", "plot_chi", "plot_training",
    "propagate", "rates", "rates_resolved", "reactionpath_minimum",
    "reactionpath_ode", "reactive_path", "readchemfile", "resample_kde",
    "resample_kde_ash", "resample_picking_features", "resample_strat",
    "resample_uncertainty", "residual_linear", "residual_ritz",
    "residual_subspace", "resolve_device", "restricted_localpdistinds", "run",
    "run_both", "run_bridges", "run_girsanov", "run_kde", "run_kde_dash",
    "run_metadynamics", "save", "save_reactive_path", "save_trajectory",
    "savecoords", "saveextrema", "scatter_ramachandran", "serve_dashboard",
    "shiftscale", "simulationtime", "smallnet", "solve_committor",
    "sqpairdist", "standardform", "subsample", "subsample_inds",
    "subsample_random", "subsample_uniformgrid", "training_lag_headroom",
    "trajectory", "trajectorydata_bursts", "trajectorydata_linear",
    "validationloss", "writechemfile",
]
