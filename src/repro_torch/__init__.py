"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The layout mirrors the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``serve``, ``obs``, ``launch``) so every module has a
counterpart there. This package imports torch and never jax, and nothing of
``repro``. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU explicitly.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
