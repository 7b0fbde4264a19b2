"""Blocked causal / windowed attention for prefill: CUDA kernel (``csrc/``),
loader (``kernel``), plain PyTorch version (``ref``) and wrapper (``ops``)."""
