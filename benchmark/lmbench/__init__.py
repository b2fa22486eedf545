"""The benchmark of lmnet_tpu_torch: shared code of the harness (see ../README.md)."""
