"""PyTorch / CUDA port of the lattice-FHE framework (second package beside
the JAX one).  Plain tensor code is PyTorch; the NTT kernels are CUDA C++
under ``csrc/``, built at first use.  Entry points run on the GPU unless the
caller passes ``device="cpu"``."""
