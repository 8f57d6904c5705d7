"""Importance weights and free-energy estimators (numpy)."""
