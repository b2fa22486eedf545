"""C++ source of the native batch loader (compiled on demand by
lmnet_tpu_torch.data.native_loader into the git-ignored build/ directory)."""
