"""HostTopology — who owns which ranks, worker slots and clients (the
port's copy of the reference's ``multihost/topology.py``).

A multi-host run is described by ONE number in the config
(``cfg.num_hosts``); everything else is derived here so that every
subsystem agrees on the layout:

* **ranks**: the worker group is host-major (``parallel/mesh.py``): host
  ``h`` holds ranks ``[h * P, (h + 1) * P)`` with ``P = num_devices /
  num_hosts``, as ``torchrun`` numbers ``RANK = GROUP_RANK *
  LOCAL_WORLD_SIZE + LOCAL_RANK``, so the host axis coincides with node
  boundaries on a real cluster, and splits the ranks of one node into
  ``num_hosts`` contiguous groups otherwise;
* **worker slots**: the round's ``[num_workers]`` cohort dimension splits
  host-major: host ``h`` owns slots ``[h * W/H, (h+1) * W/H)``. A rank
  computes the slots ``[rank * W/size, (rank + 1) * W/size)``, so a
  host's slot range lands exactly on its ranks;
* **clients**: the client population partitions contiguously by host
  (``client_partition``): host ``h`` draws its cohort slots from (and
  banks clientstore rows for) only its own range, so no client row ever
  crosses a host boundary.

Plain Python over config ints: nothing here touches a device or a process
group but ``build_topology``'s default host id, so topology objects can be
built anywhere (tests build one per host in one process).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


def slot_partition(num_workers: int, num_hosts: int,
                   host_id: int) -> Tuple[int, int]:
    """Host ``host_id``'s half-open range of global worker slots.

    Host-major contiguous split, matching the worker group's host-major
    rank order; requires the divisibility the config validator already
    enforced."""
    if num_workers % num_hosts:
        raise ValueError(
            f"num_workers ({num_workers}) must be divisible by num_hosts "
            f"({num_hosts}) — the config validator enforces this"
        )
    per = num_workers // num_hosts
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return host_id * per, (host_id + 1) * per


def client_partition(num_clients: int, num_hosts: int,
                     host_id: int) -> Tuple[int, int]:
    """Host ``host_id``'s half-open range of client ids.

    Contiguous, balanced to within one: the first ``num_clients %
    num_hosts`` hosts get the extra client each — every client is owned
    by exactly one host and the union covers ``[0, num_clients)``."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    base, extra = divmod(num_clients, num_hosts)
    lo = host_id * base + min(host_id, extra)
    return lo, lo + base + (1 if host_id < extra else 0)


@dataclass(frozen=True)
class HostTopology:
    """One host's slice of the cluster: the value every per-host
    component (data plane, client bank, bring-up checks) is built from."""

    num_hosts: int
    host_id: int
    num_workers: int       # GLOBAL cohort size (cfg.num_workers)
    num_clients: int       # GLOBAL client population
    chips_per_host: int    # ranks (one device each) of this host
    slot_range: Tuple[int, int]    # global worker slots this host owns
    client_range: Tuple[int, int]  # global client ids this host owns

    @property
    def workers_per_host(self) -> int:
        lo, hi = self.slot_range
        return hi - lo

    @property
    def clients_per_host(self) -> int:
        lo, hi = self.client_range
        return hi - lo

    def at_width(self, width: int) -> "HostTopology":
        """This host's topology at a REALIZED fleet width (the elastic
        fleet): the global cohort dimension narrows to ``width`` worker
        slots, re-split host-major; rank and client ownership are
        untouched — the group never resizes, so a width is purely a
        slot-range change (the per-host data plane feeds fewer rows, from
        the same clients, onto the same ranks)."""
        w = int(width)
        if w == self.num_workers:
            return self
        return HostTopology(
            num_hosts=self.num_hosts,
            host_id=self.host_id,
            num_workers=w,
            num_clients=self.num_clients,
            chips_per_host=self.chips_per_host,
            slot_range=slot_partition(w, self.num_hosts, self.host_id),
            client_range=self.client_range,
        )

    def owns_client(self, client_id: int) -> bool:
        lo, hi = self.client_range
        return lo <= int(client_id) < hi

    def local_client(self, client_id: int) -> int:
        """Global client id -> this host's bank row index."""
        lo, hi = self.client_range
        c = int(client_id)
        if not lo <= c < hi:
            raise ValueError(
                f"client {c} is outside host {self.host_id}'s partition "
                f"[{lo}, {hi}) — per-host banks only store the owning "
                "host's rows (multihost/topology.py client_partition)"
            )
        return c - lo


def build_topology(cfg, host_id: Optional[int] = None) -> HostTopology:
    """This host's :class:`HostTopology` from the config.

    ``host_id`` defaults to this rank's host in the initialized default
    process group (``rank // (num_devices / num_hosts)``, the worker
    group's host-major order), and to 0 without a group. A test that
    builds every host's topology in one process passes it explicitly."""
    n = int(cfg.num_hosts)
    per = int(cfg.num_devices) // n
    if host_id is None:
        import torch.distributed as dist

        host_id = (dist.get_rank() // per
                   if dist.is_available() and dist.is_initialized() else 0)
    h = int(host_id)
    return HostTopology(
        num_hosts=n,
        host_id=h,
        num_workers=int(cfg.num_workers),
        num_clients=int(cfg.num_clients),
        chips_per_host=per,
        slot_range=slot_partition(int(cfg.num_workers), n, h),
        client_range=client_partition(int(cfg.num_clients), n, h),
    )


def validate_mesh_topology(group, topology: HostTopology) -> None:
    """Reject a worker group whose host count disagrees with the topology
    — the one cross-check between the two derivations (config ints here,
    ``make_worker_group(cfg)`` there)."""
    group_hosts = int(getattr(group, "hosts", 1))
    if group_hosts != topology.num_hosts:
        raise ValueError(
            f"worker group declares {group_hosts} host(s) but the topology "
            f"was built for {topology.num_hosts} — build both from the "
            "same config (make_worker_group(cfg) + build_topology(cfg))"
        )
