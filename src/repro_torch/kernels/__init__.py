"""Attention kernels of the port: hand-written CUDA for Hopper
(``csrc/*.cu``, built by ``build.py``), each beside its plain torch
version (``ref.py``); ``ops.py`` picks one by the tensors' device."""
