"""Hand-written CUDA kernels of the port (``csrc/``), their build
(``build``), wrappers with plain PyTorch versions (``lookup``) and the
serving epilogues (``ops``)."""
