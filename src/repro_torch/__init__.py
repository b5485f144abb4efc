"""AMS-Quant in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package `repro` (src/repro), laid out one module to one
module: each file names the reference file it answers to. It imports torch
and never jax; the reference stays the oracle its tests compare against.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
