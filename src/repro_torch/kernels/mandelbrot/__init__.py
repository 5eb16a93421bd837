"""Mandelbrot escape-time dwell: hand CUDA kernel (``ops``) + plain version (``ref``)."""
