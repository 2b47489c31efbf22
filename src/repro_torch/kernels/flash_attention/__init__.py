"""Flash attention, forward (K3): the CUDA kernel (``csrc/``), its wrapper
(``ops``) and the plain PyTorch version (``ref``)."""
