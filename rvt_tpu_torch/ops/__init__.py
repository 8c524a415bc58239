"""Operators of the port: the hand-written CUDA kernels of the serving path
with their plain PyTorch versions, and the plain tensor ops around them."""
