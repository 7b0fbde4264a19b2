"""Closed-form max-stable-rate scorer: CUDA kernel (``csrc/``), loader
(``kernel``), plain PyTorch version (``ref``) and wrapper (``ops``)."""
