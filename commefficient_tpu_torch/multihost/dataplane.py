"""Per-host data plane — realize only what this host owns (the port's copy
of the reference's ``multihost/dataplane.py``).

On one host, one process realizes the whole round: the sampler's global
client draw and ``[W, B, ...]`` batch, the fedsim ``RoundEnv``'s ``[W]``
masks and (hosted client state) the full ``[num_clients, D]`` banks. On a
cluster that would make every host pay the whole population's memory and
gather bandwidth for rows it never feeds its ranks. The data plane splits
the work along :class:`~commefficient_tpu_torch.multihost.topology.
HostTopology`'s three partitions:

* **sampler** (:class:`HostDataPlane`): host ``h`` draws its
  ``W/num_hosts`` cohort slots from its OWN client partition on its own
  rng stream ``(seed, MULTIHOST_STREAM, host_id, round_idx)``: separate
  streams, deterministic and resume-stable per host, the reference's ids
  exactly. ``sample_clients`` is the draw alone (cheap ints: any process
  can compute any host's ids, which is how the full ``[W]`` id vector
  exists everywhere without shipping data); ``sample_round`` also
  realizes the batch slice.
* **fedsim** (:func:`round_env_slice`): the ``RoundEnv`` is a pure
  function of ``(seed, round_idx)``, so every host realizes it and keeps
  its slot rows; ``live_count`` and the ``fedsim/*`` stats stay GLOBAL.
* **clientstore** (:func:`build_host_bank`): the per-host bank stores
  rows for the host's client partition ONLY, addressed by global ids; a
  foreign id is a named error, not a silent wrong-row gather.

:func:`assemble_rows` lays per-host row slices out as the session's
``[W, ...]`` batch. Its form: a ``[W, ...]`` host array in which only the
rows this rank computes (``[rank * W/size, (rank + 1) * W/size)``, inside
its host's slot range) are written; every other row is allocated but
never written and never read (``FederatedSession.local_clients`` and the
index round slice this rank's rows before anything is copied or
computed), so another host's rows are never realized here. The session
and the engines downstream see an ordinary ``[W, ...]`` batch.

Nothing of this module is on the train entries' path (as in the
reference): a ``--num_hosts`` run through ``cv_train`` realizes every
host's rows on every rank. A caller builds the partitioned round from
these pieces and ``FederatedSession.train_round``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from commefficient_tpu_torch.clientstore.streamer import build_streamer
from commefficient_tpu_torch.fedsim.env import RoundEnv
from commefficient_tpu_torch.multihost.topology import HostTopology

Batch = Dict[str, np.ndarray]

# distinct rng stream tag (the reference's): (seed, MULTIHOST_STREAM,
# host_id, round_idx) can never collide with the sampler's (seed,
# round_idx) or fedsim's (seed, FEDSIM_STREAM, round_idx) tuple seeds
MULTIHOST_STREAM = 0x40057


class HostDataPlane:
    """One host's slice of the sampler: partitioned draws and local batch
    realization, ``FedSampler``'s per-round contract at
    ``[W/num_hosts, B, ...]``. ``augment(batch, rng)``, when given, runs
    on each client's gathered batch on the round's generator."""

    def __init__(self, dataset, topology: HostTopology, *,
                 local_batch_size: int, seed: int = 42, augment=None):
        if dataset.num_clients != topology.num_clients:
            raise ValueError(
                f"dataset has {dataset.num_clients} clients but the "
                f"topology was built for {topology.num_clients} — build "
                "both from the same config"
            )
        if topology.clients_per_host < topology.workers_per_host:
            raise ValueError(
                f"host {topology.host_id} owns "
                f"{topology.clients_per_host} clients but must draw "
                f"{topology.workers_per_host} distinct cohort slots per "
                "round — need num_clients >= num_workers per host "
                "partition (raise num_clients or lower num_hosts)"
            )
        self.dataset = dataset
        self.topology = topology
        self.local_batch_size = int(local_batch_size)
        self.seed = int(seed)
        self.augment = augment

    def _rng(self, round_idx: int) -> np.random.Generator:
        """This host's round stream, disjoint per host by construction
        (the host id rides the tuple seed)."""
        return np.random.default_rng(
            (self.seed, MULTIHOST_STREAM, self.topology.host_id, round_idx)
        )

    def _draw(self, rng: np.random.Generator) -> np.ndarray:
        t = self.topology
        lo, hi = t.client_range
        return (lo + rng.choice(hi - lo, size=t.workers_per_host,
                                replace=False)).astype(np.int32)

    def sample_clients(self, round_idx: int) -> np.ndarray:
        """GLOBAL client ids ``[W/num_hosts]`` for this host's slots: the
        draw alone, no batch realized."""
        return self._draw(self._rng(round_idx))

    def sample_round(
        self, round_idx: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(client_ids ``[Wl]`` global int32, batch ``{k: [Wl, B, ...]}``):
        this host's realized slice of the round, draw-then-batches on one
        generator (``FedSampler.sample_round``'s discipline), so it is a
        pure function of ``(seed, host_id, round_idx)``."""
        rng = self._rng(round_idx)
        clients = self._draw(rng)
        B = self.local_batch_size
        shards = []
        for c in clients:
            chosen = self.dataset.client_batch_indices(int(c), B, rng)
            b = {k: v[chosen] for k, v in self.dataset.data.items()}
            if self.augment is not None:
                b = self.augment(b, rng)
            shards.append(b)
        batch = {k: np.stack([s[k] for s in shards]) for k in shards[0]}
        return clients, batch

    def steps_per_epoch(self) -> int:
        """GLOBAL rounds per epoch: every host must agree on the round
        schedule, so this uses the whole cohort (``FedSampler.
        steps_per_epoch``'s)."""
        t = self.topology
        per_round = t.num_workers * self.local_batch_size
        return max(1, len(self.dataset) // per_round)

    def epoch(self, epoch_idx: int):
        steps = self.steps_per_epoch()
        base = epoch_idx * steps
        for s in range(steps):
            yield self.sample_round(base + s)


def global_client_ids(planes: Sequence[HostDataPlane],
                      round_idx: int) -> np.ndarray:
    """The full ``[W]`` id vector from every host's draw, host-major. The
    draws are ints, so every process computes all hosts' (only its own
    plane ever realizes batches)."""
    return np.concatenate([p.sample_clients(round_idx) for p in planes])


def round_env_slice(env: RoundEnv, topology: HostTopology) -> RoundEnv:
    """This host's rows of a globally realized fedsim ``RoundEnv``: the
    masks sliced to the host's slot range; ``live_count`` and the
    ``fedsim/*`` stats stay GLOBAL (the server renormalizes by the whole
    cohort's participation)."""
    lo, hi = topology.slot_range
    return RoundEnv(
        live=env.live[lo:hi],
        corrupt=env.corrupt[lo:hi],
        live_count=env.live_count,
        stats=dict(env.stats),
    )


def assemble_rows(group, host_rows: Dict[int, np.ndarray], *,
                  num_hosts: int) -> np.ndarray:
    """The session's ``[W, ...]`` array from per-host row slices, in the
    module docstring's form: only the rows this rank of ``group`` computes
    are written, from the slice of the host they belong to.

    ``host_rows`` maps host_id -> that host's ``[W/num_hosts, ...]``
    slice; it must cover the host of this rank's rows (its own, on a
    host-major group), and may leave out every other host. Rows place in
    host-major order, the group's rank order."""
    per = None
    for h, rows in host_rows.items():
        if per is None:
            per = rows.shape[0]
        elif rows.shape[0] != per:
            raise ValueError(
                f"host {h}'s slice has {rows.shape[0]} rows, expected "
                f"{per} — every host owns num_workers/num_hosts slots"
            )
    if per is None:
        raise ValueError("host_rows is empty")
    sample = next(iter(host_rows.values()))
    n = per * num_hosts
    if n % group.size:
        raise ValueError(f"{n} rows do not split over the group's "
                         f"{group.size} rank(s)")
    mine = n // group.size
    start, stop = group.rank * mine, (group.rank + 1) * mine
    h = start // per
    if h not in host_rows:
        raise ValueError(
            f"rank rows [{start}, {stop}) belong to host {h}, whose "
            "slice was not provided — a process must supply every "
            "host slice its ranks cover"
        )
    if stop > (h + 1) * per:
        raise ValueError(
            f"rank rows [{start}, {stop}) straddle a host boundary "
            f"(per-host rows={per}) — the worker group must split the "
            "row dim host-major (is it make_worker_group(cfg)'s?)"
        )
    out = np.empty((n,) + sample.shape[1:], sample.dtype)
    out[start:stop] = host_rows[h][start - h * per:stop - h * per]
    return out


def assemble_cohort(group, parts: List[Tuple[np.ndarray, Optional[Batch]]]):
    """(ids ``[W]``, batch ``{k: [W, ...]}``) from host-major per-plane
    parts, each ``(ids, batch)`` of ``sample_round``, or ``(ids, None)``
    (``sample_clients``) for a host whose rows this process does not
    realize: the bridge from the data planes to ``train_round``'s
    inputs."""
    ids = np.concatenate([p[0] for p in parts])
    n = len(parts)
    realized = {h: b for h, (_, b) in enumerate(parts) if b is not None}
    if not realized:
        raise ValueError("no part realizes a batch")
    keys = next(iter(realized.values()))
    batch = {
        k: assemble_rows(group, {h: b[k] for h, b in realized.items()},
                         num_hosts=n)
        for k in keys
    }
    return ids, batch


class _PartitionStoreCfg:
    """The config ``build_streamer`` reads, for one host's partition: the
    same store knobs, but ``num_clients`` is the PARTITION's row count and
    the mmap path carries the host id (two hosts on one filesystem must
    not share backing files)."""

    def __init__(self, cfg, topology: HostTopology):
        self.client_store = cfg.client_store
        self.client_state_hosted = cfg.client_state_hosted
        self.client_store_cache_rows = cfg.client_store_cache_rows
        self.client_store_path = (
            f"{cfg.client_store_path}.h{topology.host_id}"
            if cfg.client_store_path else ""
        )
        self.num_clients = topology.clients_per_host


class HostClientBank:
    """A ``CohortStreamer`` over ONE host's client partition, addressed by
    GLOBAL client ids: the translation (and the ownership check that makes
    a foreign id loud) lives here, so the streamer underneath is the stock
    one-host one."""

    def __init__(self, streamer, topology: HostTopology):
        self._streamer = streamer
        self.topology = topology

    def _local(self, cids) -> np.ndarray:
        cids = np.asarray(cids)
        lo, hi = self.topology.client_range
        if cids.size and (cids.min() < lo or cids.max() >= hi):
            bad = cids[(cids < lo) | (cids >= hi)]
            raise ValueError(
                f"client ids {bad.tolist()} are outside host "
                f"{self.topology.host_id}'s partition [{lo}, {hi}) — "
                "per-host banks only store the owning host's rows; draw "
                "cohorts through HostDataPlane (partitioned draws) or "
                "route the row to its owning host"
            )
        return (cids - lo).astype(cids.dtype)

    @property
    def has_vel(self) -> bool:
        return self._streamer.has_vel

    @property
    def has_err(self) -> bool:
        return self._streamer.has_err

    def gather(self, cids, trace_id=None):
        return self._streamer.gather(self._local(cids), trace_id=trace_id)

    def scatter(self, cids, new_vel, new_err, trace_id=None) -> None:
        self._streamer.scatter(self._local(cids), new_vel, new_err,
                               trace_id=trace_id)

    def is_stale(self, cids, version: int) -> bool:
        return self._streamer.is_stale(self._local(cids), version)

    def flush(self) -> None:
        self._streamer.flush()

    def vel_array(self):
        self._streamer.flush()
        return self._streamer.vel_array()

    def err_array(self):
        self._streamer.flush()
        return self._streamer.err_array()

    def pop_round_stats(self) -> dict:
        return self._streamer.pop_round_stats()

    def close(self) -> None:
        self._streamer.close()


def build_host_bank(cfg, topology: HostTopology, row_dim: int, *,
                    needs_vel: bool, needs_err: bool, stager_fn=None,
                    device="cpu") -> Optional[HostClientBank]:
    """The per-host counterpart of ``clientstore.build_streamer``: the
    same construction gate (None unless the config hosts client state and
    a bank is needed), over a store of this host's partition only."""
    streamer = build_streamer(
        _PartitionStoreCfg(cfg, topology), row_dim,
        needs_vel=needs_vel, needs_err=needs_err, stager_fn=stager_fn,
        device=device,
    )
    if streamer is None:
        return None
    return HostClientBank(streamer, topology)
