"""Paged attention, chunked prefill (K1) and decode (K2): the CUDA kernel
(``csrc/``), its wrappers (``ops``) and the plain PyTorch versions
(``ref``)."""
