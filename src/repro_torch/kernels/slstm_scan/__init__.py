"""sLSTM recurrence: CUDA kernel (``csrc/``), loader (``kernel``), plain
PyTorch version (``ref``) and wrapper (``ops``)."""
