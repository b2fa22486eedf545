"""LM-Net in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of the JAX package ``lmnet_tpu``, which stays the reference. It
mirrors that package's layout and names; see README.md ("PyTorch/CUDA
port"). It imports torch, numpy and pandas, never JAX.
"""

__version__ = "0.1.0"
