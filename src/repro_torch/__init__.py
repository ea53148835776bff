"""PyTorch / CUDA port of the FedTest round (the ``repro`` package is the
reference it is held against).

The module layout mirrors ``src/repro/`` one-to-one, so each port module
sits at the same relative path as the JAX module it replaces. The port
imports ``torch`` and never ``jax`` or anything of ``repro``; only the
parity tests import both.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU. On the card every kernel op launches its hand-written
Hopper kernel; on the CPU it runs the kernel's plain PyTorch version.
"""
