"""Simulations of the port."""

from .base import ExternalSimulation, IsoSimulation  # noqa: F401
