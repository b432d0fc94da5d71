"""PyTorch + CUDA port of ``esrnerf_tpu`` for NVIDIA Hopper (H100).

The JAX package ``esrnerf_tpu`` stays the reference; this package mirrors its
layout (``config``, ``ops``, ``models``, ``optim``, ``apps``, ``utils``) and
keeps its public layouts: ``[X,Y,Z,C]`` grids, ``[in,out]`` MLP weights,
``[N,S]`` alphas. Each Pallas kernel of the reference becomes a hand-written
CUDA kernel under ``csrc/``, built with ``nvcc`` at first use
(:mod:`esrnerf_tpu_torch.ops.kernels`); tensors on the CPU take the plain
PyTorch version that sits beside each kernel.

Importing the package builds nothing and needs no GPU.
"""
