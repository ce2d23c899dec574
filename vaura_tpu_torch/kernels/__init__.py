"""Building and loading the CUDA kernels of ``csrc/`` (see ``build``)."""
