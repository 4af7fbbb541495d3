"""Eval reductions on tensors and the hand-written CUDA kernels."""
