"""RMSNorm: CUDA kernel (``csrc/rmsnorm.cu``), wrapper (``ops``), plain version (``ref``)."""
