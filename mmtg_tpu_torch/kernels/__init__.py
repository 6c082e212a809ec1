"""Build and load the hand-written CUDA kernels (see :mod:`._build`)."""
