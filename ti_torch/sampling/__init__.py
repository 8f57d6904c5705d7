"""Fixed-step integrators and the ambient sampling driver."""
