"""Tensor primitives (dot, conv) and the hand-written CUDA kernels."""
