"""PyTorch + CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``models``, ``kernels/<name>``, ``serve``,
``launch``, ``checkpoint``) and imports neither ``jax`` nor anything of
``repro``.  Attention on the serving path runs through hand-written
CUDA kernels (``csrc/``); every other op is plain PyTorch.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
