"""Workloads of the port through its public API, each a counterpart of a
script in the JAX package's ``examples/``: ``run(..., device=None)`` runs on
the first CUDA card unless it is given ``device="cpu"``."""
