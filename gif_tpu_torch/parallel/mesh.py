"""Process groups and placement for data-parallel training (port of
:mod:`gif_tpu.parallel.mesh` over ``torch.distributed``).

The GIF model fits on one card, so the scaling axis is the batch: one
process per GPU, each holding a full replica of the train state, each fed
its own slice of the global batch, with the gradients mean-all-reduced
before every optimizer step (the JAX package's ``shard_map`` step over a
1-D ``data`` mesh with ``lax.pmean``).  Rank 0 owns the job's files:
metrics, sample grids, FID and checkpoint writes.

The backend is always the caller's choice: ``nccl`` on the cards, ``gloo``
for CPU processes (the tests) or for several ranks sharing one card.
Nothing here switches backend or device on its own.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# Rank 0 runs the FID sweep (12-28 s per 512 samples on the H100's host,
# minutes at 10k samples) while the other ranks wait in the next
# collective: the group's timeout must outlast it.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=60)


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
):
    """Join (or create) the default process group and return it.

    With no ``coordinator`` the rendezvous comes from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); otherwise ``coordinator`` is ``host:port`` and
    ``num_processes`` / ``process_id`` are the world size and this rank.
    The local rank is ``LOCAL_RANK`` where set, else the rank (one host).

    ``backend="nccl"`` needs one card per local rank: it raises when no
    card is present or the local rank has none of its own (two ranks would
    share a card, which NCCL refuses), and makes the rank's card current.
    """
    if coordinator is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no coordinator given and torchrun's environment lacks {missing}")
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        rank, world, init_method = int(process_id), int(num_processes), f"tcp://{coordinator}"
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA device; torch.cuda.is_available() is False")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank: local rank {local} of {world} ranks, "
                f"{torch.cuda.device_count()} card(s) visible"
            )
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=timeout)
    return dist.group.WORLD


def process_count(group=None) -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main_process(group=None) -> bool:
    """True on the rank that owns checkpoints, metrics, FID and sample grids."""
    return process_index(group) == 0


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when the caller names one (``cpu``
    for CPU ranks), else ``cuda:LOCAL_RANK`` (the rank on one host).
    Raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for CPU ranks")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_index())))


def choose_data_mesh_size(batch_size: int, n_dev: int, n_proc: int = 1, min_per_shard: int = 1) -> int:
    """How many devices data parallelism should span (pure logic, the
    rules of the JAX package's CLI).

    Single process: the largest device count that divides the batch with
    >= ``min_per_shard`` samples per shard (spare devices idle).
    Multi-process: every global device, or a ``ValueError`` when the batch
    does not divide among them with >= ``min_per_shard`` per shard — a
    smaller group would leave ranks out, one device would train diverging
    copies."""
    if n_dev <= 1:
        return 1
    if n_proc > 1:
        if batch_size % n_dev or batch_size // n_dev < min_per_shard:
            raise ValueError(
                f"multihost run needs batch_size divisible by the {n_dev} "
                f"global devices with >= {min_per_shard} samples per "
                f"shard; got batch_size={batch_size}"
            )
        return n_dev
    use = min(n_dev, max(1, batch_size // min_per_shard))
    while batch_size % use:
        use -= 1
    return use


def collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: this rank's
    current card under NCCL (which has no CPU collectives), else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _tensors(obj) -> list:
    """The tensors ``replicate`` broadcasts: a module's parameters and
    buffers (its state_dict: aliases of the live tensors), an optimizer's
    per-parameter state in parameter order, or the tensor itself."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for g in obj.param_groups:
            for p in g["params"]:
                out += [v for _, v in sorted(obj.state.get(p, {}).items()) if isinstance(v, torch.Tensor)]
        return out
    raise TypeError(f"cannot replicate a {type(obj).__name__}")


@torch.no_grad()
def replicate(*objs, group=None):
    """Broadcast every parameter, buffer and optimizer state of ``objs``
    (modules, optimizers, tensors) from rank 0 into the same objects on
    every rank, in place, so the replicas start equal whatever each rank
    initialised.  Tensors are broadcast in one flat bucket per device type
    and dtype; a tensor shared by two objects is sent once.  Every rank must
    hold the same structure (raises where they differ); each rank's
    tensors of a device type may sit on its own card.  Returns ``objs``
    (one object: itself)."""
    out = objs[0] if len(objs) == 1 else objs
    if process_count(group) == 1:
        return out
    seen, buckets = set(), {}
    for obj in objs:
        for t in _tensors(obj):
            key = (t.data_ptr(), t.numel(), t.dtype, t.device)
            if t.numel() and key not in seen:
                seen.add(key)
                buckets.setdefault((t.device.type, t.dtype), []).append(t)
    keys = sorted(buckets, key=lambda k: (k[0], str(k[1])))
    layout = [(k[0], str(k[1]), [tuple(t.shape) for t in buckets[k]]) for k in keys]
    layouts = [None] * process_count(group)
    dist.all_gather_object(layouts, layout, group=group)
    if any(other != layout for other in layouts):
        raise RuntimeError("replicate: the ranks hold different parameter / optimizer structures")
    src = dist.get_global_rank(group, 0) if group is not None else 0
    coll = collective_device(group)
    for key in keys:
        ts = buckets[key]
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if coll.type == "cuda" and flat.device.type != "cuda":
            flat = flat.to(coll)
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view(t.shape))
            offset += t.numel()
    return out


def shard_batch(batch: dict, device=None, group=None) -> dict:
    """This rank's slice of a global batch (equal slices along axis 0, in
    rank order), moved to ``device`` as tensors."""
    world, rank = process_count(group), process_index(group)
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % world:
            raise ValueError(f"global batch {n} ({k!r}) not divisible by {world} ranks")
        local = n // world
        out[k] = torch.as_tensor(np.asarray(v[rank * local: (rank + 1) * local])).to(device)
    return out


def host_local_tree(tree):
    """A (nested) dict / list of tensors -> the same structure of host
    numpy arrays (every rank holds the full replica, so no collective)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_tree(v) for v in tree)
    return tree
