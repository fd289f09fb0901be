"""Executors and kernels of the port."""
