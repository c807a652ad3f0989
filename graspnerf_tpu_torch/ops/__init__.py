"""Tensor functions and the two kernel wrappers of the volume path."""
