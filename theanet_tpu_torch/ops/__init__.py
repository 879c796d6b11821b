"""Kernels of the port and their plain PyTorch twins (see megastep.py)."""
