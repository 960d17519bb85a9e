"""Hand-written Hopper kernels, each with its plain PyTorch version.

``flash_attention`` (prefill), ``decode_attention`` (one-token decode
against the ring cache) and ``ssm_scan`` (the Mamba selective scan) each
hold ``csrc/`` (the CUDA source), ``ref.py`` (the plain version) and
``ops.py`` (the wrapper the model calls).
"""
