"""Mamba-2 SSD chunked scan (K5): the CUDA kernel (``csrc/``), its wrapper
(``ops``) and the plain PyTorch versions (``ref``)."""
