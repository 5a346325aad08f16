"""PyTorch/CUDA port of the FUSCO reproduction (the JAX package ``repro`` is
the reference).  Module paths mirror ``repro``: ``repro_torch.core.dcomm`` is
the counterpart of ``repro.core.dcomm`` and so on.

This package imports ``torch`` and never ``jax`` or ``repro``.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version, on a CUDA tensor it launches
the hand-written Hopper kernel under ``csrc/`` or raises.
"""
