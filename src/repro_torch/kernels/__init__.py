"""The hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Importing this package builds nothing and needs no GPU: a kernel is compiled on
its first launch (or by ``cuda.build``) and only on a machine with ``nvcc``."""
