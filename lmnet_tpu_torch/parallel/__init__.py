from lmnet_tpu_torch.parallel import dist_utils
from lmnet_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "batch_sharding", "shard_batch", "replicate", "dist_utils"]
