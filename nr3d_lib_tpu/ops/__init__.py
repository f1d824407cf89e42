"""L1: pure-function compute kernels (plain XLA)."""
