"""Integrators and the sampling drivers (ambient, latent, ADW, SDE)."""
