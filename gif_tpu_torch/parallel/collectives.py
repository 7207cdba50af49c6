"""Collectives of the data-parallel job (port of
:mod:`gif_tpu.parallel.collectives`, plus the train step's reductions).

- :func:`allgather_rows` pools host accumulators (the FID conditioning
  buffer) across ranks, each of which feeds an independent data stream;
- :func:`mean_all_reduce` averages a list of tensors (gradients, metrics)
  across ranks in one flat bucket, in place;
- :func:`differentiable_mean` averages a tensor across ranks inside an
  autograd graph (the path-length penalty's mean length).

Every rank must call each of them in the same order: they are
collectives.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gif_tpu_torch.parallel.mesh import collective_device, process_count


def allgather_rows(arrays: Sequence[np.ndarray], max_rows: int | None = None, group=None) -> Tuple[np.ndarray, ...]:
    """Gather row-aligned host arrays from every rank along axis 0.

    ``arrays`` share a leading length on each rank (which may differ
    across ranks).  Rows are interleaved round-robin across ranks (row 0
    of every rank in rank order, then row 1, ...), so a ``max_rows`` cut
    keeps a near-equal share of every rank's stream; row alignment between
    the arrays is kept.  Every rank receives the same pooled arrays.  With
    one rank: the arrays, cut to ``max_rows``."""
    arrays = tuple(np.ascontiguousarray(a) for a in arrays)
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("allgather_rows arrays must be row-aligned")
    world = process_count(group)
    if world == 1:
        return tuple(a[:max_rows] for a in arrays)
    dev = collective_device(group)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([n], dtype=torch.int64, device=dev), group=group)
    counts = np.array([int(c.item()) for c in counts])
    cap = int(counts.max())
    # The round-robin order over the (rank, row) grid, the same for every
    # array: valid (row, rank) pairs sorted by row.
    rows = np.arange(cap)[:, None]
    flat_idx = (np.arange(world)[None, :] * cap + rows)[rows < counts[None, :]]
    out = []
    for a in arrays:
        padded = np.zeros((cap,) + a.shape[1:], a.dtype)
        padded[:n] = a
        mine = torch.from_numpy(padded).to(dev)
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine, group=group)
        gathered = torch.stack(parts).cpu().numpy()  # (world, cap, ...)
        out.append(gathered.reshape((-1,) + gathered.shape[2:])[flat_idx][:max_rows])
    return tuple(out)


@torch.no_grad()
def mean_all_reduce(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce (sum) of their concatenation, then a division by the world
    size, so every rank ends with the same bits.  The tensors share a
    device and dtype.  Counts its calls in ``mean_all_reduce.calls``."""
    world = process_count(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mean_all_reduce.calls += 1
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()


mean_all_reduce.calls = 0


class _DifferentiableMean(torch.autograd.Function):
    """Mean across ranks whose backward is the same mean of the incoming
    gradients: the transpose of ``lax.pmean`` in the JAX package's
    ``shard_map`` step (``check_vma=False``), psum over ranks then the
    division by the world size."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        mean_all_reduce([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        mean_all_reduce([g], ctx.group)
        return g, None


def differentiable_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` averaged over the ranks of ``group``, differentiable (the
    gradient flows back through the same mean); ``x`` itself when
    ``group`` is None."""
    if group is None:
        return x
    return _DifferentiableMean.apply(x, group)
