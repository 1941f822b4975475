"""Operations of the port, with the CUDA kernel wrappers."""
