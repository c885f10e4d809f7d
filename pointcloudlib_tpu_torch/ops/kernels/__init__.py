"""Hand-written Hopper kernels and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it
and an integer ``launches`` count on the wrapper function, raised by one
per kernel launch and nowhere else. Nothing here imports a compiler or
builds anything at import time: ``_build`` compiles ``csrc/*.cu`` at the
first launch.
"""
