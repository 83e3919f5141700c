"""PyTorch + hand-written CUDA port of the FPDT system for NVIDIA Hopper.

Each module mirrors the JAX package's module at the same relative path and
imports nothing from it: what it needs (configs, ``pair_live``, ...) is kept
as its own copy here.  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"`` / ``--device cpu``); on the CPU every kernel
wrapper runs its plain PyTorch version.
"""
