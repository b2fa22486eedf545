"""The ('data', 'spatial') device mesh over the ranks of a process group.

Counterpart of ``lmnet_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``, ``replicate``). A rank stands for one
device of JAX's mesh. JAX's ``data`` axis becomes a split of every global
batch into contiguous row blocks, one a rank (``shard_rows``); what XLA
gives a sharded batch for free, a rank's step takes from ``parallel/batch.py``:
the loss and every BatchNorm statistic over the global batch, and the
gradients' mean over the ranks.

Every rank builds the same global batch, and the same augmentation draws
for it, then keeps its own rows. A batch whose rows do not divide by the
data axis (an eval set's ragged tail) is split as ``numpy.array_split``
splits it: the first ``B % W`` ranks take one row more. The counts are
those of JAX's replication fallback (``mesh.py:64-66``), which computes the
same function. The global batch is the batch the caller built on every
rank; JAX's multi-host mode makes it W x the local batch instead
(``mesh.py:74-86``), a rule the port does not follow.

'spatial' (sharding the image H over ranks, halo exchanges inserted by
XLA's partitioner) is not ported: ``n_spatial`` must be 1.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(n_data: int | None = None, n_spatial: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_data, n_spatial) with dims ('data',
    'spatial') over the default process group (``init_distributed_mode``
    first). ``n_data`` defaults to the world size; ``n_spatial`` must be 1
    (H-sharding is not ported)."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_spatial != 1:
        raise NotImplementedError(f"n_spatial={n_spatial}: sharding H over ranks is not ported "
                                  "(ROADMAP A8b)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "dist_utils.init_distributed_mode first")
    world = dist.get_world_size()
    n_data = world // n_spatial if n_data is None else n_data
    if n_data * n_spatial != world:
        raise ValueError(f"mesh {n_data}x{n_spatial} != {world} ranks")
    return init_device_mesh(device_type, (n_data, n_spatial), mesh_dim_names=("data", "spatial"))


def data_group(mesh):
    """The process group of ``mesh``'s 'data' axis."""
    return mesh.get_group("data")


def shard_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``: contiguous blocks in
    rank order, the first ``n % W`` one row longer (``numpy.array_split``)."""
    w, r = mesh.size(0), mesh.get_local_rank("data")
    base, extra = divmod(n, w)
    start = r * base + min(r, extra)
    return slice(start, start + base + (r < extra))


def sum_float64(parts, group, device) -> list[torch.Tensor]:
    """Each of ``parts`` (tensors or numbers) in float64 on ``device`` (a
    CUDA device under NCCL), summed over ``group`` by one all-reduce of
    their concatenation (not summed when ``group`` is None); returned in
    their shapes."""
    flat = [torch.as_tensor(p, dtype=torch.float64).to(device).reshape(-1) for p in parts]
    payload = torch.cat(flat)
    if group is not None:
        dist.all_reduce(payload, group=group)
    out, offset = [], 0
    for p, f in zip(parts, flat):
        out.append(payload[offset:offset + f.numel()].reshape(torch.as_tensor(p).shape))
        offset += f.numel()
    return out


def eval_totals(cm, terms, hd_sum, hd_cnt, group=None):
    """An eval pass's totals from its accumulators, summed over ``group``
    (the ranks that hold rows of the same batches; one process when None)
    in one float64 all-reduce: the confusion matrix, each batch's CE
    (numerator, denominator) in ``terms`` (one (2,) tensor a batch, zeros
    for a batch this rank holds no row of) and the HD95 sum and count.
    Returns (matrix (int64), the loss summed over the batches, each the
    batch's numerator over its denominator, hd_sum, hd_cnt)."""
    device = cm.device
    nd = torch.stack(terms) if terms else torch.zeros((0, 2), device=device)
    cm64, nd, hd = sum_float64([cm, nd, [hd_sum, hd_cnt]], group, device)
    return (cm64.round().to(torch.int64), float((nd[:, 0] / nd[:, 1]).sum()),
            float(hd[0]), int(hd[1]))


def batch_sharding(mesh, spatial: bool = True):
    """The placements of an NHWC batch on ``mesh``: B over 'data' (``Shard(0)``),
    H over 'spatial' (``Shard(1)``; a size-1 axis, so a whole image a rank)
    with ``spatial``, else replicated there."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(1) if spatial else Replicate())


def shard_batch(mesh, images, labels, spatial: bool = True):
    """This rank's rows (``shard_rows``) of a global batch, numpy arrays or
    tensors, as tensors on this rank's device (the card's current one on a
    CUDA mesh). ``spatial`` is accepted for JAX's signature; 'spatial' has
    one rank."""
    rows = shard_rows(mesh, len(images))
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))

    def take(a):
        part = a[rows]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(device)

    return take(images), take(labels)


def _broadcast_tensors(tensors, src: int = 0, group=None) -> None:
    """Broadcast each tensor in place; NCCL carries CUDA tensors only, so a
    CPU tensor (AdamW's step counts) goes through the current card there."""
    nccl = dist.get_backend(group) == "nccl"
    for t in tensors:
        t = t.data if isinstance(t, torch.nn.Parameter) else t
        if nccl and t.device.type != "cuda":
            tmp = t.to(torch.device("cuda", torch.cuda.current_device()))
            dist.broadcast(tmp, src, group=group)
            t.copy_(tmp)
        else:
            dist.broadcast(t, src, group=group)


def replicate(mesh, tree: Any) -> Any:
    """Make ``tree`` rank 0's on every rank of ``mesh``'s 'data' axis, in
    place, by ``broadcast``: a module's parameters and buffers, or a
    ``TrainState``'s (its model's, its optimiser's state tensors and its
    step). Returns ``tree``."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, torch.nn.Module):
        _broadcast_tensors(list(tree.parameters()) + list(tree.buffers()), src, group)
        return tree
    replicate(mesh, tree.model)
    step = torch.tensor([tree.step], dtype=torch.int64)
    _broadcast_tensors([v for s in tree.optimizer.state.values() for v in s.values()
                        if isinstance(v, torch.Tensor)] + [step], src, group)
    tree.step = int(step)
    return tree
