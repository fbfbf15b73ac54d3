"""Ops of the port: losses and the hand-written CUDA kernels."""
