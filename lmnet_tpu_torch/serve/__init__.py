from lmnet_tpu_torch.serve.engine import (
    autoselect_backends,
    deploy_forward,
    pick_fastest,
    serving_evaluate,
)

__all__ = ["autoselect_backends", "deploy_forward", "pick_fastest", "serving_evaluate"]
