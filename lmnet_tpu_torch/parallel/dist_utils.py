"""Process-level distributed helpers on ``torch.distributed``.

Counterpart of ``lmnet_tpu/parallel/dist_utils.py`` (the reference's
``utils/distributed_utils.py:7-70``), with its six names:

  init_distributed_mode  -> ``init_process_group`` from torchrun's or
                            SLURM's environment; a no-op without one
  cleanup                -> ``destroy_process_group``
  get_world_size/rank    -> the default group's size and this rank
  is_main_process        -> rank 0 (gates the CSV, checkpoint and figure
                            writes)
  reduce_value           -> one ``all_reduce`` (JAX gathers, then sums)

A rank stands for one device of JAX's ``data`` axis, and a node (a host)
for one JAX process: ``host_index``, ``host_count`` and
``local_world_size`` are JAX's ``process_index``, ``process_count`` and
the process's local device count, read from the launcher (torchrun's
GROUP_RANK and LOCAL_WORLD_SIZE, SLURM's SLURM_NODEID, SLURM_NNODES and
tasks per node; one host without them) and checked across the ranks once
the group is up: every node runs the same number L of ranks, numbered
node-major (rank = node x L + local rank).

On a card the backend is NCCL, one card a rank (``LOCAL_RANK``); gloo only
when the caller asks for it (``backend='gloo'``: two ranks sharing one
card, whose CUDA tensors gloo all-reduces through the host) or on the CPU.
An NCCL init that fails raises; nothing falls back to gloo or to the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# (this rank's host, the hosts, ranks a host), set by init_distributed_mode
_HOSTS: tuple[int, int, int] | None = None


def _env_world() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) from torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK, else SLURM's SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID
    (the reference's order, :8-14); None without a launcher."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    elif "SLURM_PROCID" in os.environ:
        rank, world = int(os.environ["SLURM_PROCID"]), int(os.environ.get("SLURM_NTASKS", "1"))
        local = int(os.environ.get("SLURM_LOCALID", rank))
    else:
        return None
    return rank, world, local


def _slurm_tasks_per_node(nodes: int, world: int) -> int:
    """SLURM's tasks per node: SLURM_NTASKS_PER_NODE, else the first count of
    SLURM_TASKS_PER_NODE ('4(x2)' or '4,3'), else the world over the
    nodes."""
    for key in ("SLURM_NTASKS_PER_NODE", "SLURM_TASKS_PER_NODE"):
        if key in os.environ:
            return int(os.environ[key].split(",")[0].split("(")[0])
    return max(world // nodes, 1)


def _env_host(rank: int, world: int, local: int) -> tuple[int, int, int]:
    """(this rank's node, its rank on the node, ranks on its node) from
    torchrun's GROUP_RANK and LOCAL_WORLD_SIZE, else SLURM's SLURM_NODEID
    and tasks per node; one node of the whole world without them."""
    if "GROUP_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["GROUP_RANK"]), local, int(os.environ["LOCAL_WORLD_SIZE"])
    if "SLURM_PROCID" in os.environ and "SLURM_NODEID" in os.environ:
        nodes = int(os.environ.get("SLURM_NNODES", "1"))
        return int(os.environ["SLURM_NODEID"]), local, _slurm_tasks_per_node(nodes, world)
    return 0, rank, world


def _check_hosts(node: int, local: int, size: int, device: torch.device) -> tuple[int, int, int]:
    """(node, nodes, ranks a node) after one all-gather of every rank's
    (node, local rank, ranks on its node); raises (every rank alike) unless
    the nodes hold equal numbers of ranks, numbered node-major."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = torch.tensor([node, local, size], dtype=torch.int64, device=device)
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    table = [tuple(int(v) for v in t.cpu()) for t in every]
    sizes = sorted({s for _, _, s in table})
    if len(sizes) > 1 or world % sizes[0]:
        raise RuntimeError(f"the nodes hold unequal numbers of ranks ({sizes} of a world of "
                           f"{world}): every node must run the same number, as every JAX "
                           "process owns the same number of devices")
    size = sizes[0]
    wrong = [(r, n, lr) for r, (n, lr, _) in enumerate(table) if r != n * size + lr]
    if wrong:
        raise RuntimeError(f"the ranks are not numbered node-major (rank = node x {size} + "
                           f"local rank); (rank, node, local rank) {wrong[:4]}: the launcher "
                           "must give each node a contiguous block of ranks")
    return table[rank][0], world // size, size


def init_distributed_mode(device: torch.device | str = "cuda", backend: str | None = None) -> None:
    """Join the process group the environment describes (torchrun: RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; SLURM: SLURM_PROCID,
    SLURM_NTASKS, SLURM_LOCALID with MASTER_ADDR and MASTER_PORT set by
    the job), a group of one too (``torchrun --nproc_per_node 1``). Does
    nothing for a process no launcher started, as the reference's "Not
    using distributed mode" branch (:15-18) and JAX's (:28-66), or if a
    group exists.

    ``device``: 'cuda' (the card; NCCL, this rank's card ``LOCAL_RANK``
    made the current one) or 'cpu' (gloo). ``backend='gloo'`` with 'cuda'
    keeps the ranks on the card gloo can share (``LOCAL_RANK`` modulo the
    cards), as two ranks on one card need: NCCL refuses them.

    Then the nodes (``host_index``, ``host_count``, ``local_world_size``)
    from the launcher, checked by one all-gather: a RuntimeError on every
    rank, the group destroyed, where the nodes hold unequal numbers of
    ranks or a node's ranks are not a contiguous block."""
    if dist.is_initialized():
        return
    env = _env_world()
    if env is None:
        return
    rank, world, local = env
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed_mode(device='cuda'): no CUDA device here; "
                               "pass device='cpu' to run on the CPU")
        n = torch.cuda.device_count()
        if backend == "nccl" and local >= n:
            raise RuntimeError(f"LOCAL_RANK {local} has no card of its own ({n} here); NCCL "
                               "takes one card a rank")
        torch.cuda.set_device(local % n)
        torch.cuda.init()  # DeviceMesh keeps an initialised current device
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    on = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    global _HOSTS
    try:
        _HOSTS = _check_hosts(*_env_host(rank, world, local), torch.device(on))
    except RuntimeError:
        dist.destroy_process_group()
        raise


def cleanup() -> None:
    """The reference's :31-32: destroy the process group, if one exists."""
    global _HOSTS
    _HOSTS = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_dist_avail_and_initialized() -> bool:
    """The reference's :35-41."""
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """The reference's :44-47: 1 without a process group."""
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    """The reference's :50-53: 0 without a process group."""
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def _hosts() -> tuple[int, int, int]:
    if _HOSTS is None or not is_dist_avail_and_initialized():
        return 0, 1, get_world_size()
    return _HOSTS


def host_index() -> int:
    """This rank's node: JAX's ``process_index`` (0 on one node)."""
    return _hosts()[0]


def host_count() -> int:
    """The nodes: JAX's ``process_count`` (1 without a launcher that names
    nodes, or for a group not made by ``init_distributed_mode``)."""
    return _hosts()[1]


def local_world_size() -> int:
    """The ranks of a node, JAX's local device count: the world on one
    node."""
    return _hosts()[2]


def is_main_process() -> bool:
    """The reference's :56-57: the gate for checkpoint and CSV writes."""
    return get_rank() == 0


def reduce_value(value, average: bool = True):
    """``value`` summed (``average``: averaged) over the ranks, by one
    ``all_reduce`` (the reference's :60-70); ``value`` itself for one
    process. A tensor keeps its device (a CUDA tensor under NCCL); a number
    becomes a tensor on the backend's device."""
    if get_world_size() < 2:
        return value
    if isinstance(value, torch.Tensor):
        t = value.clone()
    else:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.as_tensor(value, device=dev)
        if not t.is_floating_point():
            t = t.to(torch.float64)
    dist.all_reduce(t)
    return t / get_world_size() if average else t
