"""Flash-attention forward: CUDA kernel (``csrc/flash_attention.cu``), wrapper (``ops``),
plain version (``ref``)."""
