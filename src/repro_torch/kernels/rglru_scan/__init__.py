"""RG-LRU linear-recurrence scan: CUDA kernel (``csrc/``), loader
(``kernel``), plain PyTorch version (``ref``) and wrapper (``ops``)."""
