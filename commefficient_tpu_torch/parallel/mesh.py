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

* ``shift(t, step)``: send ``t`` to rank ``rank + step`` and receive
  the tensor of rank ``rank - step`` (modulo ``size``): ``ppermute`` with
  the ring permutation, the K/V rotation of ring attention.

``SingleWorker`` is the one-device group: its collectives are identities
and it needs no ``torch.distributed`` at all.

Point-to-point (``exchange``, ``shift``) on a gloo group with a CUDA
tensor is staged through pinned host buffers: gloo's ``isend``/``irecv``
cannot carry a CUDA pointer (its collectives stage CUDA tensors
themselves). The staging is transport only: the tensor goes to the host,
across, and back to its device; NCCL groups and CPU tensors never take
it, and ``CollectiveCounter.staged`` counts each staged call.

The process grid (``make_grid``): the reference's mesh is ``(workers,
model, seq)``; the port runs one process per mesh position, rank ``w * M
* S + m * S + s`` (the mesh's device order), and builds three groups: the
workers group (the ranks sharing ``(m, s)``: the round's data partition
and every round collective), the model group (sharing ``(w, s)``) and
the seq group (sharing ``(w, m)``). A group of one rank is a
``SingleWorker``; each group counts its own collectives.

The host axis (``cfg.num_hosts``, multihost/): a group of ``size`` ranks
over ``hosts`` hosts is host-major, as ``torchrun`` numbers its ranks
(``RANK = GROUP_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK``): host ``h`` holds
ranks ``[h * P, (h + 1) * P)``, ``P = workers_per_host = size / hosts``.
A group carries ``hosts``, ``host_id`` (this rank's host) and
``workers_per_host`` (the reference's ``worker_axes(mesh)``). Every
collective stays ONE call over the whole group, the reference's one
reduction over the ``(hosts, workers)`` tuple axis: declaring hosts
changes no sum. As in the reference, no round path runs the sparse
butterfly's two-level schedule (``axis_sizes=``).

``DistributedWorkers`` counts its own calls in ``counter``, a
``CollectiveCounter``: per op (the reference's HLO names: ``all-reduce``,
``all-gather``, ``reduce-scatter``, ``collective-permute``) the calls and
the per-rank RESULT bytes, the convention of the reference's collective
walk, and the largest all-gather and all-reduce in elements. The counts
are host arithmetic on shapes, with no sync and no copy;
``telemetry/round_audit.py`` reads round 0's. ``SingleWorker`` moves no
bytes between devices and counts nothing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist

from commefficient_tpu_torch.telemetry.round_audit import COLLECTIVE_OPS


class CollectiveCounter:
    """The worker group's collectives since the last ``reset()``: per op
    ``{"count", "bytes"}`` (bytes of each call's per-rank result), and
    ``max_all_gather_elems`` / ``max_all_reduce_elems`` (None until one
    is counted)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ops = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
        self.max_all_gather_elems = None
        self.max_all_reduce_elems = None
        # point-to-point calls staged through pinned host memory (gloo
        # with a CUDA tensor): {"count", "bytes"} of the tensors sent
        self.staged = {"count": 0, "bytes": 0}

    def add(self, op: str, elems: int, nbytes: int) -> None:
        self.ops[op]["count"] += 1
        self.ops[op]["bytes"] += int(nbytes)
        if op == "all-gather":
            self.max_all_gather_elems = max(self.max_all_gather_elems or 0,
                                            int(elems))
        elif op == "all-reduce":
            self.max_all_reduce_elems = max(self.max_all_reduce_elems or 0,
                                            int(elems))

    def snapshot(self) -> dict:
        """The reference's ``collective_audit`` layout: ``{"ops": {op:
        {"count", "bytes"}} (ops with calls only), "total_bytes",
        "max_all_gather_elems", "max_all_reduce_elems"}``."""
        return {
            "ops": {k: dict(v) for k, v in self.ops.items() if v["count"]},
            "total_bytes": sum(v["bytes"] for v in self.ops.values()),
            "max_all_gather_elems": self.max_all_gather_elems,
            "max_all_reduce_elems": self.max_all_reduce_elems,
        }


def _count(counter, op: str, t: torch.Tensor, mul: int = 1,
           div: int = 1) -> None:
    """Count one call whose per-rank result is ``t``'s size times ``mul``
    over ``div``."""
    elems = t.numel() * mul // div
    counter.add(op, elems, elems * t.element_size())


class SingleWorker:
    """The group of one device: identity collectives (counted nowhere:
    nothing moves between devices)."""

    rank = 0
    size = 1
    counter = None
    hosts = 1
    host_id = 0
    workers_per_host = 1

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
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

    def __init__(self, group=None, hosts: int = 1):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.counter = CollectiveCounter()
        if hosts < 1 or self.size % hosts:
            raise ValueError(
                f"a group of {self.size} rank(s) does not split into "
                f"{hosts} host(s): every host holds size / num_hosts ranks")
        self.hosts = int(hosts)
        self.workers_per_host = self.size // self.hosts
        self.host_id = self.rank // self.workers_per_host

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        _count(self.counter, "all-reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        _count(self.counter, "all-reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        _count(self.counter, "all-gather", t, self.size)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not "
                             f"split over {self.size} ranks")
        _count(self.counter, "reduce-scatter", t, div=self.size)
        out = torch.empty((t.shape[0] // self.size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def exchange(self, t: torch.Tensor, partner: int) -> torch.Tensor:
        _count(self.counter, "collective-permute", t)
        return self._p2p(t, partner, partner)

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``t`` to rank ``rank + step`` and receive rank ``rank -
        step``'s tensor of the same shape (modulo ``size``)."""
        _count(self.counter, "collective-permute", t)
        return self._p2p(t, (self.rank + step) % self.size,
                         (self.rank - step) % self.size)

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r) \
            if self.group is not None else r

    def _p2p(self, t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """``t`` sent to group rank ``to``, a tensor like it received from
        ``frm``; through pinned host buffers on gloo with a CUDA tensor."""
        t = t.contiguous()
        staged = t.is_cuda and dist.get_backend(self.group) == "gloo"
        if staged:
            self.counter.staged["count"] += 1
            self.counter.staged["bytes"] += t.numel() * t.element_size()
            send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            send.copy_(t)
        else:
            send = t
        out = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, self._peer(to),
                           group=self.group),
                dist.P2POp(dist.irecv, out, self._peer(frm),
                           group=self.group)]):
            req.wait()
        return out.to(t.device) if staged else out

    def all_reduce_sum_async(self, t: torch.Tensor):
        _count(self.counter, "all-reduce", t)
        work = dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=True)
        return _Pending(work, lambda: t)

    def all_gather_async(self, t: torch.Tensor):
        _count(self.counter, "all-gather", t, self.size)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        work = dist.all_gather(parts, t, group=self.group, async_op=True)
        return _Pending(work, lambda: torch.cat(parts))


# the grid's axes, as the reference's mesh names them (a Grid's attributes)
WORKERS, MODEL, SEQ = "workers", "model", "seq"


class Grid:
    """The process grid of ``make_grid``: the ``workers``, ``model`` and
    ``seq`` groups of this rank, its ``rank`` in the whole grid and the
    grid's ``size`` (``workers.size * model.size * seq.size``)."""

    def __init__(self, workers, model, seq, rank: int = 0):
        self.workers, self.model, self.seq = workers, model, seq
        self.rank = int(rank)
        self.size = workers.size * model.size * seq.size

    @property
    def lead(self) -> bool:
        """Rank 0 of the whole grid: the one rank that prints and
        writes."""
        return self.rank == 0


def _subgroup(ranks, rank: int):
    """``dist.new_group(ranks)`` (every rank of the world calls it, in the
    same order), as this rank's group when it is a member."""
    g = dist.new_group(ranks)
    return DistributedWorkers(g) if rank in ranks else None


def build_grid(workers: int, model: int = 1, seq: int = 1,
               hosts: int = 1) -> Grid:
    """The ``workers x model x seq`` grid over the initialized default
    group (whose size must be the product; one process needs none).
    Every rank creates every subgroup in the same order: the workers
    groups by ``(m, s)``, the model groups by ``(w, s)``, the seq groups
    by ``(w, m)``."""
    W, M, S = int(workers), int(model), int(seq)
    if not (dist.is_available() and dist.is_initialized()):
        return Grid(SingleWorker(), SingleWorker(), SingleWorker())
    rank = dist.get_rank()
    if M * S == 1:  # the default group is the workers group
        return Grid(DistributedWorkers(hosts=hosts), SingleWorker(),
                    SingleWorker(), rank)
    w, m, s = rank // (M * S), rank // S % M, rank % S

    def at(w_, m_, s_):
        return w_ * M * S + m_ * S + s_

    layouts = {
        "workers": [[at(x, a, b) for x in range(W)]
                    for a in range(M) for b in range(S)],
        "model": [[at(a, x, b) for x in range(M)]
                  for a in range(W) for b in range(S)],
        "seq": [[at(a, b, x) for x in range(S)]
                for a in range(W) for b in range(M)],
    }
    mine = {}
    for name, groups in layouts.items():
        if len(groups[0]) == 1:
            mine[name] = SingleWorker()
            continue
        for ranks in groups:
            g = _subgroup(ranks, rank)
            if g is not None:
                mine[name] = g
    assert (mine["workers"].rank, mine["model"].rank,
            mine["seq"].rank) == (w, m, s)
    return Grid(mine["workers"], mine["model"], mine["seq"], rank)


def make_grid(cfg) -> Grid:
    """The grid of ``cfg.num_devices`` workers x ``cfg.model_axis`` x
    ``cfg.seq_axis``, one process per position. One position needs no
    process group; more need an initialized default group of exactly
    that size, which ``torchrun`` and ``join_from_env`` provide (the
    workers group must split into ``cfg.num_hosts`` hosts)."""
    W = int(cfg.num_devices)
    M, S = int(cfg.model_axis), int(cfg.seq_axis)
    need = W * M * S
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if world != need:
        raise RuntimeError(
            f"num_devices={W} x model_axis={M} x seq_axis={S} needs {need} "
            f"process(es) but the torch.distributed group has {world}"
            + ("" if initialized else " (none is initialized)")
            + ": run one process per grid position, e.g. `torchrun "
            f"--nproc_per_node {need} -m "
            "commefficient_tpu_torch.train.cv_train ... --num_devices "
            f"{W} --model_axis {M} --seq_axis {S}`")
    return build_grid(W, M, S, hosts=int(cfg.num_hosts))


def make_worker_group(cfg):
    """The workers group of ``make_grid(cfg)``: ``cfg.num_devices``
    devices over ``cfg.num_hosts`` hosts."""
    return make_grid(cfg).workers


def local_rank() -> int:
    """This process's device index on its host (``LOCAL_RANK``, as
    ``torchrun`` sets it; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


# the coordinator environment env:// reads
COORDINATOR_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _coordinator_address() -> str:
    """The coordinator this process dials, for the bring-up's error."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return "<unset>"


def _connect_with_retry(cfg) -> None:
    """``init_process_group(init_method="env://")``, NCCL for
    ``device='cuda'`` (each process on ``cuda:LOCAL_RANK``) and gloo for
    the CPU, under a bounded retry-with-backoff.

    Nodes rarely start in lockstep, and one that dials before the
    coordinator listens gets a connect error. Under ``--distributed``,
    ``cfg.distributed_connect_retries`` is the TOTAL attempt budget
    (default 3, floored at 1); without it one attempt. The backoff
    doubles from 1 s. The final failure names the coordinator address and
    the attempts spent, chained to the last error."""
    attempts = (max(1, int(getattr(cfg, "distributed_connect_retries", 3)))
                if getattr(cfg, "distributed", False) else 1)
    cuda = getattr(cfg, "device", "cpu") == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank())
    delay = 1.0
    last = None
    for attempt in range(1, attempts + 1):
        try:
            dist.init_process_group(backend="nccl" if cuda else "gloo",
                                    init_method="env://")
            return
        # a refused or timed-out rendezvous surfaces as RuntimeError or
        # ValueError from init_process_group; re-raised with context
        # after the attempt budget is spent
        except Exception as e:
            last = e
            if attempt < attempts:
                time.sleep(delay)
                delay *= 2.0
    raise RuntimeError(
        f"could not join the multi-host coordinator at "
        f"{_coordinator_address()} after {attempts} attempt(s) "
        f"(--distributed_connect_retries): {last}"
    ) from last


def _check_cluster(cfg) -> None:
    """A ``--distributed`` run's joined group against its config: the node
    count (``WORLD_SIZE / LOCAL_WORLD_SIZE``) must be ``num_hosts`` and
    the world ``num_devices``."""
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = world // max(per_node, 1)
    if nodes != cfg.num_hosts:
        raise ValueError(
            f"joined a {nodes}-node cluster (WORLD_SIZE {world} / "
            f"LOCAL_WORLD_SIZE {per_node}) but --num_hosts is "
            f"{cfg.num_hosts}: the host axis must coincide with node "
            f"boundaries (one host per node) — set --num_hosts {nodes}"
        )
    if world != cfg.num_devices:
        raise ValueError(
            f"joined a cluster of {world} process(es) but --num_devices is "
            f"{cfg.num_devices}: the worker group runs one process per "
            f"device — set --num_devices {world}"
        )


def join_from_env(cfg) -> bool:
    """The one env:// bring-up; returns whether it initialized the default
    process group (a group that exists already is used as is).

    * ``cfg.distributed``: the coordinator environment (``MASTER_ADDR``,
      ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) is required (the
      alternative is a one-process run silently pretending to be a
      cluster), the connect retries with backoff, and the joined group
      must have ``num_hosts`` nodes of ``num_devices`` ranks in all.
    * otherwise: one attempt when the grid has more than one position
      (``num_devices x model_axis x seq_axis``) and ``torchrun``'s
      ``WORLD_SIZE`` is set; without it nothing is initialized, and
      ``make_grid`` names what is missing."""
    grid = cfg.num_devices * cfg.model_axis * cfg.seq_axis
    start = not dist.is_initialized() and (
        cfg.distributed or (grid > 1 and "WORLD_SIZE" in os.environ))
    if start:
        if cfg.distributed and any(not os.environ.get(k)
                               for k in COORDINATOR_ENV):
            raise RuntimeError(
                "--distributed was set but no multi-host coordinator is "
                "configured: export MASTER_ADDR + MASTER_PORT + WORLD_SIZE "
                "+ RANK (torchrun --nnodes N sets them), or drop "
                "--distributed to run the host axis over the ranks of one "
                "node")
        _connect_with_retry(cfg)
    if cfg.distributed:
        _check_cluster(cfg)
    return start


@contextlib.contextmanager
def distributed_from_env(cfg):
    """``join_from_env(cfg)`` for the body of the ``with``: a group it
    initialized is destroyed on exit, one the caller initialized (two
    ranks on one card joined by gloo) is used as is."""
    start = join_from_env(cfg)
    try:
        yield
    finally:
        if start:
            dist.destroy_process_group()
