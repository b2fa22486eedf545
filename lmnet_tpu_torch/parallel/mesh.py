"""The ('data', 'spatial') device mesh over the ranks of a process group.

Counterpart of ``lmnet_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``, ``replicate``). A rank stands for one
device of JAX's mesh. JAX's ``data`` axis becomes a split of every global
batch into contiguous row blocks, one a rank (``shard_rows``); what XLA
gives a sharded batch for free, a rank's step takes from ``parallel/batch.py``:
the loss and every BatchNorm statistic over the global batch, and the
gradients' mean over the ranks.

A node (``dist_utils.host_index``, of ``host_count``) stands for one JAX
process, its L ranks for that process's devices. Every rank of a node
builds the node's batch, and the same augmentation draws for it, then
keeps its own rows (``node_rows``); the global batch is the nodes' batches
in node order, N x the node's batch, as JAX's ``make_array_from_process_
local_data`` makes it (``mesh.py:74-91``). The data axis is node-major, so
a rank's rows of the global batch (``shard_rows``) lie inside its node's
batch, at the offset node x the node's batch. On one node the node's batch
is the global batch. A batch whose rows do not divide by a node's data
ranks (an eval set's ragged tail) is split as ``numpy.array_split`` splits
it: the first ``B % W`` ranks take one row more. The counts are those of
JAX's replication fallback (``mesh.py:64-66``), which computes the same
function.

JAX's 'spatial' axis shards the image H: rank s of the axis holds the s-th
block of rows of every image its data rank holds (``shard_batch(...,
spatial=True)``), and the step runs inside ``shard_context``, where the
model exchanges halos and sums over the blocks (``parallel/spatial.py``).
The port shards H only where it divides by 16 x the axis (``shards_h``), so
that every rank holds at least one row at the bottleneck and two at the
smallest NAT stage; otherwise it does what JAX's fallback does (``mesh.py:
93-97``, H replicated): every rank of the axis runs the whole image, and
computes the same function. Sums over a sharded batch go over the world
(every rank holds other pixels), over the data axis otherwise
(``sum_group``); the gradients' mean is over the world either way.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from lmnet_tpu_torch.metrics.hd95 import hausdorff_distance_95
from lmnet_tpu_torch.parallel.dist_utils import host_count, local_world_size
from lmnet_tpu_torch.parallel.batch import current_shard, shard
from lmnet_tpu_torch.parallel.spatial import gather_rows


def make_mesh(n_data: int | None = None, n_spatial: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_data, n_spatial) with dims ('data',
    'spatial') over the default process group (``init_distributed_mode``
    first): rank r is (r // n_spatial, r % n_spatial), so the ranks of one
    image's blocks are neighbours. ``n_data`` defaults to the world size
    over ``n_spatial``; their product must be the world size. On several
    nodes ``n_spatial`` must divide the ranks of a node, so that the ranks
    of an image's blocks share a node (JAX would stack the nodes' images
    along H instead)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "dist_utils.init_distributed_mode first")
    world = dist.get_world_size()
    n_data = world // n_spatial if n_data is None else n_data
    if n_data * n_spatial != world:
        raise ValueError(f"mesh {n_data}x{n_spatial} != {world} ranks")
    if host_count() > 1 and local_world_size() % n_spatial:
        raise ValueError(f"a 'spatial' axis of {n_spatial} ranks must divide the "
                         f"{local_world_size()} ranks of a node")
    return init_device_mesh(device_type, (n_data, n_spatial), mesh_dim_names=("data", "spatial"))


def data_group(mesh):
    """The process group of ``mesh``'s 'data' axis."""
    return mesh.get_group("data")


def spatial_group(mesh):
    """The process group of ``mesh``'s 'spatial' axis: the ranks holding the
    blocks of rows of the same images."""
    return mesh.get_group("spatial")


def shards_h(mesh, H: int, spatial: bool = True) -> bool:
    """Whether a batch of height ``H`` is sharded over the 'spatial' axis:
    asked for, an axis of more than one rank, and H a multiple of 16 x the
    axis (each rank then holds H / 16 / n_spatial >= 1 rows at the
    bottleneck)."""
    n = mesh.size(1)
    return bool(spatial) and n > 1 and H % (16 * n) == 0


def h_rows(mesh, H: int) -> slice:
    """This rank's block of rows of a map of height ``H``."""
    n, s = mesh.size(1), mesh.get_local_rank("spatial")
    return slice(s * H // n, (s + 1) * H // n)


def shard_context(mesh, sharded: bool):
    """The context a step on this rank's blocks of rows runs in
    (``parallel/batch.py::shard``), or a null context."""
    if not sharded:
        return contextlib.nullcontext()
    return shard(spatial_group(mesh), mesh.get_local_rank("spatial"), mesh.size(1))


def sum_group(mesh, sharded: bool):
    """The ranks whose counts add up to the global batch's: the world where H
    is sharded, else the data axis (each rank of the 'spatial' axis then
    holds the same pixels)."""
    return dist.group.WORLD if sharded else data_group(mesh)


def _split(n: int, w: int, r: int) -> slice:
    """Block ``r`` of ``numpy.array_split(range(n), w)``."""
    base, extra = divmod(n, w)
    start = r * base + min(r, extra)
    return slice(start, start + base + (r < extra))


def shard_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``: contiguous blocks in
    rank order, the first ``n % W`` one row longer (``numpy.array_split``)."""
    return _split(n, mesh.size(0), mesh.get_local_rank("data"))


def node_ranks(mesh) -> int:
    """The data ranks of a node: the data axis over the nodes."""
    return mesh.size(0) // host_count()


def node_rows(mesh, n: int) -> slice:
    """This rank's rows of its node's batch of ``n``, split over the node's
    data ranks as ``numpy.array_split`` splits it (``shard_rows`` on one
    node). Where ``n`` divides by them, these are the rank's rows of the
    global batch of N x ``n`` (``shard_rows``) less node x ``n``."""
    if host_count() == 1:
        return shard_rows(mesh, n)
    per = node_ranks(mesh)
    return _split(n, per, mesh.get_local_rank("data") % per)


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


def eval_totals(cm, terms, hd_sum, hd_cnt, group=None, slot: int = 0, slots: int = 1,
                ragged: bool = False):
    """An eval pass's totals from its accumulators, summed over ``group``
    (the ranks that hold rows of the same batches; one process when None)
    in one float64 all-reduce: the confusion matrix, each batch's CE
    (numerator, denominator) in ``terms`` (one (2,) tensor a batch, zeros
    for a batch this rank holds no row of) and the HD95 sum and count.
    Returns (matrix (int64), the loss summed over the batches, each the
    batch's numerator over its denominator, hd_sum, hd_cnt).

    ``slots``: the loaders of ``group`` whose batches are batches of their
    own (JAX's cross-host eval: one a node), this rank's loader being
    ``slot``; batch i of one slot is summed over the ranks of that slot
    alone. ``ragged``: the loaders may differ in length; the batches are
    counted to the longest (one MAX all-reduce first) and a batch that no
    rank of a slot held adds nothing."""
    device = cm.device
    nd = torch.stack(terms) if terms else torch.zeros((0, 2), device=device)
    if ragged and group is not None:
        longest = torch.tensor([len(nd)], dtype=torch.int64, device=device)
        dist.all_reduce(longest, op=dist.ReduceOp.MAX, group=group)
        nd = torch.cat([nd, nd.new_zeros((int(longest) - len(nd), 2))])
    grid = nd.new_zeros((slots, *nd.shape))
    grid[slot] = nd
    cm64, grid, hd = sum_float64([cm, grid, [hd_sum, hd_cnt]], group, device)
    num, den = grid[..., 0].reshape(-1), grid[..., 1].reshape(-1)
    ratios = num / den
    if ragged or slots > 1:  # a batch of a slot that no rank of it held
        ratios = ratios[den > 0]
    return cm64.round().to(torch.int64), float(ratios.sum()), float(hd[0]), int(hd[1])


def hd95_values(preds: torch.Tensor, labels: torch.Tensor) -> list[float]:
    """The HD95 of a batch's class-1 masks at each image where both are
    non-empty, on the host. Inside a shard, of the whole maps gathered over
    its ranks (JAX computes HD95 on the global arrays), on its first rank
    alone, so that ``eval_totals`` over the world counts each image once."""
    preds, labels = gather_rows(preds), gather_rows(labels)
    s = current_shard()
    if s is not None and s.index:
        return []
    vals = [hausdorff_distance_95(p == 1, t == 1)
            for p, t in zip(preds.cpu().numpy(), labels.cpu().numpy())]
    return [v for v in vals if not np.isnan(v)]


def batch_sharding(mesh, spatial: bool = True):
    """The placements of an NHWC batch on ``mesh``: B over 'data' (``Shard(0)``),
    H over 'spatial' (``Shard(1)``) with ``spatial``, else replicated there."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(1) if spatial else Replicate())


def shard_batch(mesh, images, labels, spatial: bool = True):
    """This rank's rows (``node_rows``) of its node's NHWC batch and its (B,
    H, W) labels, numpy arrays or tensors (on one node the global batch),
    as tensors on this rank's device (the card's current one on a CUDA
    mesh); with ``spatial``, of those rows this rank's block of H
    (``h_rows``) where ``shards_h`` allows it, else whole images (JAX's
    fallback)."""
    rows = node_rows(mesh, len(images))
    H = images.shape[1]
    hs = h_rows(mesh, H) if shards_h(mesh, H, spatial) else slice(0, H)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))

    def take(a):
        part = a[rows][:, hs]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(device)

    return take(images), take(labels)


def _broadcast_tensors(tensors) -> None:
    """Broadcast each tensor in place from rank 0; NCCL carries CUDA tensors
    only, so a CPU tensor (AdamW's step counts) goes through the current
    card there."""
    nccl = dist.get_backend() == "nccl"
    for t in tensors:
        t = t.data if isinstance(t, torch.nn.Parameter) else t
        if nccl and t.device.type != "cuda":
            tmp = t.to(torch.device("cuda", torch.cuda.current_device()))
            dist.broadcast(tmp, 0)
            t.copy_(tmp)
        else:
            dist.broadcast(t, 0)


def replicate(mesh, tree: Any) -> Any:
    """Make ``tree`` rank 0's on every rank of ``mesh``, in place, by
    ``broadcast`` over the world: a module's parameters and buffers, or a
    ``TrainState``'s (its model's, its optimiser's state tensors and its
    step). Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        _broadcast_tensors(list(tree.parameters()) + list(tree.buffers()))
        return tree
    replicate(mesh, tree.model)
    step = torch.tensor([tree.step], dtype=torch.int64)
    _broadcast_tensors([v for s in tree.optimizer.state.values() for v in s.values()
                        if isinstance(v, torch.Tensor)] + [step])
    tree.step = int(step)
    return tree
