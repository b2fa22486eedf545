from lmnet_tpu_torch.serve.engine import deploy_forward, serving_evaluate

__all__ = ["deploy_forward", "serving_evaluate"]
