"""Tools that measure the port on a CUDA card."""
