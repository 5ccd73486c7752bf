"""PyTorch/CUDA port of the GMLake reproduction.

Mirrors ``repro``'s module names so each counterpart is easy to find; it
imports ``torch`` and never ``jax``, and nothing of ``repro``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; the three stitch
kernels are CUDA C++ for ``sm_90a`` under ``csrc/`` (see ``kernels/``).
"""
