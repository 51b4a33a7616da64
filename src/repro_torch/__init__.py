"""ZipFlow decode path in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays in the tree as the reference).
The layout mirrors it: ``core`` (plans, stage IR, fusion, compiler, executor),
``algos`` (codecs), ``kernels`` (the Fully-Parallel, Group-Parallel and
Non-Parallel CUDA kernels and their plain PyTorch versions) and ``data`` (TPC-H
columns and the ``ColumnPipeline`` entry point).  Nothing here imports JAX or ``repro``.
"""
