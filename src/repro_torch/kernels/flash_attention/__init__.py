"""Flash attention (K3): the CUDA kernel (``csrc/``), its wrapper with the
gradient (``ops``), the backward in torch ops (``backward``) and the plain
PyTorch version (``ref``)."""
