"""The plain reference of the benchmark: float32 PyTorch, no kernels, no
cache, no batching; it imports nothing of the program it judges."""
