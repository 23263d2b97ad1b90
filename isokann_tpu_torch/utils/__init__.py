"""Trajectory I/O, molecular utilities, plots, dashboards, telemetry and
op counts; counterpart of ``isokann_tpu/utils``.  Importing it needs no
matplotlib: the plotting functions import it when called."""

from .plots import (
    plot_training, plot_chi, scatter_ramachandran,
    plot_reactive_path, vismodel, plot_targets, plot_potential,
    scatter_chifix, scatter_chi_simplex, autoplot,
)
from .telemetry import profile, Timers, ThroughputLogger
from .gui import serve_dashboard, livegui, interactive_gui, InteractiveGui
from .lazytraj import LazyTrajectory, LazyMultiTrajectory
from .molutils import (
    phi_psi, aligned_rmsd_to, ca_rmsd, ReactionCoordsRMSD, standardform,
    getpdb,
)
from .save import savecoords, saveextrema, load_trajectory, save_trajectory
