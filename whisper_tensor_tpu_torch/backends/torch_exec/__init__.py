"""Eager PyTorch execution of milli graphs."""
