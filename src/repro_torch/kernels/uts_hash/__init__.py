"""UTS SHA-1 child digests: hand CUDA kernel (``ops``) + plain version (``ref``)."""
