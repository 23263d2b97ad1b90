"""Simulations of the port."""
