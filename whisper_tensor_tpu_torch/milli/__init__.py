"""Lowerings of the reference's milli ops to PyTorch."""
