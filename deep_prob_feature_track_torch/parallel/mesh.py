"""The mesh: a ``torch.distributed`` process group, one process per card.

Counterpart of ``deep_prob_feature_track_tpu/parallel/mesh.py``.  A JAX mesh
step is the global program, sharded: its BatchNorm statistics, its
batch-global min/max and its loss mean run over the global batch, and every
device applies the same update.  The port keeps those semantics with
explicit collectives while a mesh is :func:`active`:

- ``models/layers.py``'s BatchNorm all-reduces the sums its mean and
  variance come from (:func:`all_reduce_sum`, which autograd differentiates);
- every batch-global min/max of the tracker, the losses and the evaluation
  goes through :func:`extrema_mask`;
- ``training/train.py`` divides each rank's loss by the global sample count
  and sums the gradients across ranks before the clip.

A plain ``DistributedDataParallel`` wrapper would give per-replica
BatchNorm statistics and per-shard min/max instead: the original PyTorch
implementation's ``nn.DataParallel`` semantics, not the JAX package's.

The group's backend follows the device: NCCL on ``cuda``, gloo on ``cpu``;
``backend="gloo"`` on the card runs several ranks on one card (NCCL refuses
two ranks on one device), and gloo takes CUDA tensors in ``all_reduce`` and
``broadcast`` alone, so rows are gathered by an ``all_reduce`` of a
zero-padded buffer (:func:`all_gather_rows`).  The JAX package's 2-D
``batch_shardings(spatial_axis=...)`` layout and its buffer donation are XLA
placement choices without a function of their own: they have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group over ``world`` ranks, this process being ``rank``,
    on ``device``."""

    group: Any
    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(device="cuda", backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The process group of all ranks, initialised where it is not yet.

    Without ``init_method`` the group comes from ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; a lone
    process without them is a group of one on a free local port).  A rank on
    the card takes card ``LOCAL_RANK`` (NCCL) or the card it was given
    (gloo).

    :param device: the card unless ``"cpu"`` is asked for
    :param backend: NCCL on the card and gloo on the CPU by default
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            init_method, rank, world_size = f"tcp://localhost:{free_port()}", 0, 1
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kwargs = {} if init_method is None else {"init_method": init_method, "rank": rank,
                                                 "world_size": world_size}
        dist.init_process_group(backend, **kwargs)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)


def free_port() -> int:
    """A free TCP port on this host."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def destroy() -> None:
    """Tear this process's group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the active mesh: the global reductions of a sharded program

# The one process-wide setting of this module: the JAX package's mesh is
# ambient to the program it shards, and the reductions it changes sit deep
# in the tracker (``models/``, ``solvers/``, ``ops/``), so the mesh is set
# for a block (:func:`active`) rather than passed down every call.
_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[None]:
    """Within the block, batch reductions run over ``mesh``'s global batch
    (``None``: over this process's own tensors)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    """The active mesh, or None."""
    return _ACTIVE


def extrema_mask(x: torch.Tensor) -> torch.Tensor:
    """``(x == x.amin()) | (x == x.amax())``, the extrema taken over the
    global batch while a mesh is active (this process's tensor alone
    otherwise).  The mask carries no gradient."""
    lo, hi = x.detach().amin(), x.detach().amax()
    mesh = _ACTIVE
    if mesh is not None and mesh.world > 1:
        lo, hi = lo.clone(), hi.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    return (x == lo) | (x == hi)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (every rank's copy of the sum feeds that rank's part of the loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` (default the active
    one), differentiable; ``x`` itself without a mesh."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None or mesh.world == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


# --------------------------------------------------------------------------
# batches across ranks

def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that ``mesh``'s rank holds:
    contiguous equal blocks in rank order (``n`` must divide by the
    world size)."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not divide over {mesh.world} ranks")
    size = n // mesh.world
    return slice(mesh.rank * size, (mesh.rank + 1) * size)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch dict: every array, tensor and
    list leaf is cut along its first dimension."""
    n = len(batch["pad_mask"]) if "pad_mask" in batch else next(
        len(v) for v in batch.values() if hasattr(v, "__len__"))
    rows = batch_sharding(mesh, n)
    return {k: v[rows] if hasattr(v, "__getitem__") and not isinstance(v, str) else v
            for k, v in batch.items()}


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.int64: torch.int64,
         torch.int32: torch.int32, torch.bool: torch.int32, torch.uint8: torch.int32}


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order, on every
    rank, bit for bit: each rank writes its rows, as integers of the same
    width, into a zero buffer and the buffers are summed (gloo's CUDA
    tensors take ``all_reduce`` and ``broadcast`` alone)."""
    if mesh.world == 1:
        return x
    ints = _BITS[x.dtype]
    src = x.to(ints) if x.dtype in (torch.bool, torch.uint8) else x.contiguous().view(ints)
    buf = src.new_zeros((mesh.world * x.shape[0],) + tuple(x.shape[1:]))
    buf[mesh.rank * x.shape[0]:(mesh.rank + 1) * x.shape[0]] = src
    dist.all_reduce(buf, group=mesh.group)
    if x.dtype in (torch.bool, torch.uint8):
        return buf.to(x.dtype)
    return buf.view(x.dtype)


def replicate(mesh: Mesh, module: torch.nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0, group=mesh.group)
