"""Training: the updater chain, the solver and iteration listeners."""
