"""The process layer: one process per device over ``torch.distributed``.

Port of adv_grpo_tpu/parallel/mesh.py (``gather_global`` :107,
``process_allgather`` :133), of the differentiable ``jax.lax.all_gather``
the PickScore criterion uses, and of the CLI's ``maybe_init_distributed``
(adv_grpo_tpu/cli/train.py:20-37), in torch's idiom. The JAX package is one
controller per host over a device mesh; here every device has its own
process, as ``torchrun`` launches them, and each process holds only its own
rows. So ``put_batch`` and ``to_local_np`` have no counterpart: a rank's
tensors already are its shard of the batch.

Where no process group is initialized (a plain single-process run) every
collective here is the identity, as the JAX helpers are at
``process_count() == 1``. Where a group is initialized, the collectives run
even at world size 1, so that a one-rank group on the card exercises them.
NCCL serves CUDA tensors, gloo CPU tensors.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600  # a collective that waits longer than this fails instead of hanging

# The flat-tensor collectives. torch 2.13 names them ``all_gather_single`` /
# ``reduce_scatter_single`` and warns on the older names; torch 2.11 has only
# the older ``all_gather_into_tensor`` / ``reduce_scatter_tensor``.
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def env_requests_group() -> bool:
    """True when the environment describes a process group (``torchrun`` sets
    ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(backend: Optional[str] = None, *, device=None,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group; a no-op when one is already initialized.

    Without ``init_method`` the group is read from torchrun's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    With one (``tcp://host:port``, ``file:///path``) ``world_size`` and
    ``rank`` are given or read from ``WORLD_SIZE`` / ``RANK``. The backend
    defaults to NCCL for a CUDA ``device`` and gloo otherwise (``device``
    defaults to CUDA when a card is visible)."""
    if dist.is_initialized():
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1 if init_method else -1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0 if init_method else -1))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def world_size(group=None) -> int:
    """The number of ranks in ``group`` (None: the default group); 1 where
    no group is initialized."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (None: the default group); 0 where
    no group is initialized."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_rank(group, group_rank: int) -> int:
    """The default group's rank of ``group``'s rank ``group_rank`` (the peer
    that point-to-point ops take)."""
    if not dist.is_initialized():
        return group_rank
    return dist.get_global_rank(group or dist.group.WORLD, group_rank)


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's device index on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device for NCCL, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _numeric(a, what):
    a = np.asarray(a)
    if a.dtype == object or a.dtype.kind in ("U", "S"):
        raise TypeError(f"{what} requires numeric arrays; gather prompt ids or dataset "
                        "indices, not strings (the reference's tokenized-prompt trick, "
                        "train_sd3_fast_pickscore.py:962-969)")
    return a


def all_gather_dim0(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along dim 0
    in rank order, in a new tensor: a copy of ``x`` where no group is
    initialized. (Gloo takes only this concatenated output form.)"""
    x = x.contiguous()
    if not dist.is_initialized():
        return x.clone()
    out = torch.empty((world_size(group) * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_flat(out, x, group=group)
    return out


def reduce_scatter_dim0(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of this rank's chunk of ``x``, dim 0 cut into
    ``world_size(group)`` equal chunks in rank order (the backward of
    :func:`all_gather_dim0`); ``x`` itself where no group is initialized."""
    if not dist.is_initialized():
        return x
    out = torch.empty((x.shape[0] // world_size(group),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_flat(out, x.contiguous(), group=group)
    return out


class _AllGatherDim0(torch.autograd.Function):
    """:func:`all_gather_dim0` whose backward is its transpose, the
    reduce-scatter of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim0(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim0(grad, ctx.group), None


def all_gather_dim0_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_gather_dim0` that autograd differentiates: the gradient of
    this rank's rows is the sum over ranks of the gradients each rank's
    output gives them (the JAX ``all_gather``'s transpose, the reference's
    ``torch.distributed.nn.all_gather``). The identity where no group is
    initialized."""
    return _AllGatherDim0.apply(x, group)


def _allgather_np(a: np.ndarray) -> np.ndarray:
    """(P, *a.shape): every rank's ``a`` (the same shape on every rank)."""
    t = torch.from_numpy(np.array(a)).to(comm_device())
    return all_gather_dim0(t[None]).cpu().numpy()


def gather_global(x):
    """Gather a per-process NUMERIC array along axis 0.

    Returns ``(global_array, local_slice)`` where ``global_array[local_slice]``
    is this process's rows: the gather -> statistic -> slice-back of the
    advantages (adv_grpo_tpu/train/driver.py:602-618). Every rank passes the
    same shape; strings and objects raise ``TypeError``."""
    x = _numeric(x, "gather_global")
    if not dist.is_initialized():
        return x, slice(0, x.shape[0])
    g = _allgather_np(x)
    n = x.shape[0]
    return g.reshape((-1,) + x.shape[1:]), slice(rank() * n, (rank() + 1) * n)


def process_allgather(tree):
    """Gather a dict / list / tuple of per-process NUMERIC arrays: each leaf
    comes back stacked, (P, *shape), in rank order. The identity where no
    group is initialized; strings and objects raise ``TypeError``."""
    if isinstance(tree, dict):
        leaves = {k: _numeric(v, "process_allgather") for k, v in tree.items()}
    else:
        leaves = [_numeric(v, "process_allgather") for v in tree]
    if not dist.is_initialized():
        return tree
    if isinstance(leaves, dict):
        return {k: _allgather_np(v) for k, v in leaves.items()}
    return type(tree)(_allgather_np(v) for v in leaves)


def barrier() -> None:
    """Wait for every rank of the default group (NCCL: on this rank's current
    device); a no-op where no group is initialized."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def broadcast_one_to_all(buf):
    """Rank 0's numeric array on every rank (the save-dir timestamp)."""
    buf = _numeric(buf, "broadcast_one_to_all")
    if not dist.is_initialized():
        return buf
    t = torch.from_numpy(np.array(buf)).to(comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def all_reduce_mean_(tensors) -> None:
    """Average ``tensors`` (on the group's device) across ranks, in place,
    through one flat buffer: the data-parallel gradient mean. A no-op where
    no group is initialized."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_sum_np(a):
    """The sum over ranks of a numeric array (identity without a group)."""
    a = _numeric(a, "all_reduce_sum_np")
    if not dist.is_initialized():
        return a
    t = torch.from_numpy(np.array(a)).to(comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()
