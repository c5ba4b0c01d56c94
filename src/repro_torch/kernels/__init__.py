"""Hand-written CUDA kernels for Hopper, their wrappers and op dispatch.

Importing this package compiles nothing; ``cuda_lib`` builds a kernel the
first time a wrapper launches it on a CUDA tensor.
"""
