"""Cut-traffic load of candidate placements: CUDA kernel (``csrc/``),
loader (``kernel``), plain PyTorch version (``ref``) and wrapper (``ops``)."""
