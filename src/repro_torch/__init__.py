"""PyTorch/CUDA port of the Serpens SpMV system.

Mirrors the layout of the JAX reference package (``repro``) but imports
nothing of it and never imports JAX: the numpy host layer (stream format,
partitioning, parallel encode) is carried as the port's own copy, and the
device layer runs on PyTorch tensors with hand-written CUDA kernels
(``kernels/csrc``).  Importing this package or its host-layer modules does
not import torch, so encode worker processes stay light.
"""
