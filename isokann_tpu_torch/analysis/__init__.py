"""Analysis of the port: reactive paths, reaction paths, mutual
information, Ulam / MSM ground truths, free energy and the committor;
counterpart of ``isokann_tpu/analysis``."""

from . import msm  # noqa: F401
from .committor import committor_system, solve_committor  # noqa: F401
from .freeenergy import (constrained_free_energy, delta_G,  # noqa: F401
                         integrate_chi, local_mean_force,
                         marginal_free_energy, sample_uniform_chi_coords)
from .minimumpath import (energyminimization_chilevel,  # noqa: F401
                          minimize_levelset, reactionforce,
                          reactionpath_minimum, reactionpath_ode)
from .msm import (chi_msm_correlation, containment_R,  # noqa: F401
                  disconnected_trajectories, eigenfunction_on_samples,
                  grid_assign, implied_timescale, koopman_eigenfunctions,
                  ramachandran_msm, subspace_spectrum,
                  ulam_transition_matrix)
from .mutualinformation import kde_mi, mutual_information  # noqa: F401
from .reactivepath import (FromToPath, FullPath, MaxPath,  # noqa: F401
                           QuantilePath, bellman_ford_dense, dtmask,
                           reactive_path, save_reactive_path,
                           shortestchain, shortestpath)
