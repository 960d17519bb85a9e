"""PyTorch and CUDA port of the Nexus model-serving stack.

The package beside ``repro`` (the JAX reference) that runs the same
serving path on an NVIDIA GPU: configs, the tensor-tree codec, the dense
decoder, its two attention kernels written by hand for Hopper, the host
I/O modules the serve driver reaches, and the serve driver itself. It
imports ``torch``, never ``jax``, and nothing of ``repro``.
"""
