"""Hand-written Hopper kernels, their plain PyTorch versions, and the dispatch.

``ops`` is the models' entry point; ``ref`` holds the plain versions;
``flash_attention`` wraps the CUDA kernel in ``csrc/``; ``_build`` compiles
it with ``nvcc`` at first use on the card.
"""
