"""PyTorch/CUDA port of the BlobShuffle tensor data plane.

Laid out like ``repro`` so that each module sits where its JAX
counterpart does. The port imports ``torch`` and numpy only: nothing of
``jax`` and nothing of ``repro``. Functions that take tensors run where
the tensors lie; a CUDA tensor goes through the hand-written Hopper
kernels under ``repro_torch.kernels`` (built with ``nvcc`` at first use),
a CPU tensor through their plain PyTorch versions.
"""
