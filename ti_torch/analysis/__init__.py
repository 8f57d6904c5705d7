"""Importance weights, free-energy estimators, the ADW potential and the
reweighted gEDMD pipelines (numpy)."""
