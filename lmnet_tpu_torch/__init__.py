"""LM-Net in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of the JAX package ``lmnet_tpu``, which stays the reference. It
mirrors that package's layout and names; see README.md ("PyTorch/CUDA
port"). It imports torch, numpy and scipy, never JAX; cv2, pandas,
scikit-learn and matplotlib only inside the functions that decode images,
build manifests or plot, so the card host needs none of them.
"""

__version__ = "0.1.0"
