"""PyTorch/CUDA port of tpu_ddp, held against the JAX package as its
reference. Entry points take an explicit ``device`` and run on the card
unless the caller passes ``device="cpu"``; the hand-written Hopper
kernels live under ``ops/csrc/`` and are built with nvcc at first use.
"""
