"""Mamba-2 SSD chunked scan (K5): the CUDA kernel (``csrc/``), its wrapper
with the gradient (``ops``), the backward by recompute (``backward``) and
the plain PyTorch versions (``ref``)."""
