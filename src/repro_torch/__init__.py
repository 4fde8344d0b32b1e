"""PyTorch/CUDA port of the modality-aware MLLM serving system.

The JAX package ``repro`` beside it is the unchanged reference this port is
held against. The port keeps the JAX package's module names (``configs``,
``models``, ``kernels``, ``cache``, ``core``, ``serving``, ``train``,
``launch``) and imports nothing from it, and nothing of JAX. Its entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""
