"""Mamba2 SSD scan: CUDA kernel (``csrc/ssd.cu``), wrapper (``ops``), plain versions (``ref``)."""
