"""Operators of the port: ``kernels`` holds the hand-written CUDA kernels
and their plain PyTorch versions."""
