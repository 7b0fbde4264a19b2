"""B x P policy sweep of the streaming runtime's window step: CUDA kernel
(``csrc/``), loader (``kernel``), plain PyTorch version (``ref``) and
wrapper (``ops``)."""
