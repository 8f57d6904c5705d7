"""cPaiNN velocity field, its dense pair forward and the flax weight bridge."""
