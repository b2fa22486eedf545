from lmnet_tpu_torch.serve.daemon import DynamicBatcher
from lmnet_tpu_torch.serve.engine import (
    autoselect_backends,
    deploy_forward,
    pick_fastest,
    serving_evaluate,
)
from lmnet_tpu_torch.serve.export import export_deploy, load_deploy, save_deploy

__all__ = ["deploy_forward", "autoselect_backends", "DynamicBatcher", "export_deploy",
           "load_deploy", "save_deploy", "pick_fastest", "serving_evaluate"]
