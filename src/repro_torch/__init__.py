"""PyTorch/CUDA port of the HiHGNN system in ``repro``.

The tree mirrors ``repro`` (``graphs``, ``core``, ``kernels``,
``models.hgnn``, ``obs``, ``serve``, ``launch``).  It imports ``torch``
and ``numpy``, never ``jax`` and nothing from ``repro``.  Every Pallas
kernel on a ported path is a hand-written CUDA kernel for Hopper under
``csrc/``, with its plain PyTorch version beside its wrapper.
"""
