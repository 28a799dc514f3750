"""Load generator: the monitored PyTorch workload.

A small transformer (bf16 matmuls, f32 master weights) whose attention
runs on the port's flash-attention CUDA kernels, stepped by
:mod:`.run` while the port's in-process monitor samples the card.
"""
