"""Decode attention over a contiguous KV cache (K4): the CUDA kernel
(``csrc/``), its wrapper (``ops``) and the plain PyTorch version
(``ref``)."""
