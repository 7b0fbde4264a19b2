"""Single-token GQA attention over a KV cache: CUDA kernel (``csrc/``),
loader (``kernel``), plain PyTorch version (``ref``) and wrapper (``ops``)."""
