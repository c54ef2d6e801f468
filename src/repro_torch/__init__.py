"""repro_torch — AsyBADMM (block-wise asynchronous distributed ADMM for
general form consensus, arXiv:1802.08882) in PyTorch, with the epoch's
fused kernels written in CUDA C++ for Hopper.

The package mirrors ``repro`` (the JAX reference) module by module:
``repro_torch/core/space.py`` ports ``repro/core/space.py``, and so on.
It imports neither JAX nor ``repro``. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``. See README.md.
"""
