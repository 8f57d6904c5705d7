"""cPaiNN velocity field, its dense pair forward, the ADW MLP and the flax
weight bridge."""
