"""Twins of the JAX package's example programs (``examples/``), each
runnable as ``python -m lattigo_tpu_torch.examples.<name>``."""
