"""The worker group: the port's counterpart of the reference's ``workers``
mesh axis (``parallel/mesh.py``), one process per device.

The reference runs every device of the workers axis inside one program
(``shard_map``); the port runs one process per device, joined by
``torch.distributed`` (NCCL on cards, gloo on the CPU). A group offers only
what the round needs, with collectives that both backends implement:

* ``rank`` and ``size`` (the axis index and the axis size);
* ``all_reduce_sum`` / ``all_reduce_max`` (``psum`` / ``pmax``), in place;
* ``all_gather``: every rank's tensor concatenated along dim 0 in rank
  order (``all_gather(...).reshape(-1)``);
* ``reduce_scatter``: the sum over ranks of a ``[size * S]`` tensor, of
  which each rank keeps its ``[S]`` slice (``psum_scatter(...,
  tiled=True)``), the sparse aggregation's and FSDP's gradient exchange;
* ``exchange(t, partner)``: send ``t`` to rank ``partner`` and receive
  its tensor of the same shape (``ppermute`` with a hypercube pairing),
  the butterfly of ``sparse_allreduce_sharded``;
* ``all_reduce_sum_async`` / ``all_gather_async``: the collective started
  now, with a handle whose ``wait()`` completes it and returns the result
  (one collective a leaf group or a segment, issued while other work
  runs: the layerwise overlap).

``SingleWorker`` is the one-device group: its collectives are identities
and it needs no ``torch.distributed`` at all.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


class SingleWorker:
    """The group of one device: identity collectives."""

    rank = 0
    size = 1

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_sum_async(self, t: torch.Tensor):
        return _Done(t)

    def all_gather_async(self, t: torch.Tensor):
        return _Done(t)


class _Done:
    """The handle of a collective that has already completed."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def wait(self) -> torch.Tensor:
        return self.t


class _Pending:
    """The handle of an asynchronous collective: ``wait()`` completes it
    and returns ``finish()``."""

    def __init__(self, work, finish):
        self.work, self.finish = work, finish

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.finish()


class DistributedWorkers:
    """The workers of an initialized ``torch.distributed`` process group,
    one process per device. The reductions work in place on the tensor
    given (which they return)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not "
                             f"split over {self.size} ranks")
        out = torch.empty((t.shape[0] // self.size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def exchange(self, t: torch.Tensor, partner: int) -> torch.Tensor:
        t = t.contiguous()
        out = torch.empty_like(t)
        peer = dist.get_global_rank(self.group, partner) \
            if self.group is not None else partner
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, peer, self.group),
                dist.P2POp(dist.irecv, out, peer, self.group)]):
            req.wait()
        return out

    def all_reduce_sum_async(self, t: torch.Tensor):
        work = dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=True)
        return _Pending(work, lambda: t)

    def all_gather_async(self, t: torch.Tensor):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        work = dist.all_gather(parts, t, group=self.group, async_op=True)
        return _Pending(work, lambda: torch.cat(parts))


def make_worker_group(cfg):
    """The group for ``cfg.num_devices`` devices. One device needs no
    process group; more need an initialized default group of exactly that
    size (one process per device), which ``torchrun`` and
    ``distributed_from_env`` provide."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if world != cfg.num_devices:
        raise RuntimeError(
            f"num_devices={cfg.num_devices} but the torch.distributed group "
            f"has {world} process(es)"
            + ("" if initialized else " (none is initialized)")
            + ": run one process per device, e.g. `torchrun "
            f"--nproc_per_node {cfg.num_devices} -m "
            "commefficient_tpu_torch.train.cv_train ... --num_devices "
            f"{cfg.num_devices}`")
    return DistributedWorkers() if initialized else SingleWorker()


def local_rank() -> int:
    """This process's device index on its host (``LOCAL_RANK``, as
    ``torchrun`` sets it; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


@contextlib.contextmanager
def distributed_from_env(cfg):
    """Initialize the default process group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when
    ``cfg.num_devices > 1`` and no group exists yet, and destroy it on
    exit. NCCL for ``device='cuda'`` (each process on ``cuda:LOCAL_RANK``),
    gloo for ``device='cpu'``. Without that environment nothing is
    initialized, and ``make_worker_group`` names what is missing."""
    start = (cfg.num_devices > 1 and "WORLD_SIZE" in os.environ
             and not dist.is_initialized())
    if start:
        if cfg.device == "cuda":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(
            backend="nccl" if cfg.device == "cuda" else "gloo",
            init_method="env://")
    try:
        yield
    finally:
        if start:
            dist.destroy_process_group()
