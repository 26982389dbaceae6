"""clientstore/: per-client state in host memory, streamed a cohort at a
time (the port's copy of ``commefficient_tpu/clientstore/``).

The local-momentum and local-error banks are ``[num_clients, D]``, while a
round touches only its W participants' rows. With ``--client_store
device`` (the default) the banks are ``FedState`` tensors on the device
and this package builds NOTHING. With ``--client_store host|mmap`` the
banks live in a ``store.py`` bank (host RAM, or a memory-mapped file), the
cohort's rows go to the card through the ``CohortStreamer`` (fronted,
with ``--client_store_cache_rows``, by the ``cache.py`` LRU of device
rows), the round takes them as arguments, and its new rows go back to
the bank asynchronously: the population is bounded by host memory or
disk instead of the card's memory, with the same numbers as the device
banks (README "Host-resident client state in the port").

Imports torch and numpy, never JAX. ``parallel/api.py`` builds the
streamer; ``utils/config.py`` mirrors the registry's kinds as
``CLIENT_STORES`` (tests/test_torch_clientstore.py pins them equal).
"""

from commefficient_tpu_torch.clientstore.cache import LRURowCache
from commefficient_tpu_torch.clientstore.store import (
    ClientStateStore,
    DeviceStore,
    HostStore,
    MmapStore,
    available_stores,
    build_store,
    register,
)
from commefficient_tpu_torch.clientstore.streamer import (
    CohortStreamer,
    StagedCohort,
    build_streamer,
)

__all__ = [
    "ClientStateStore",
    "CohortStreamer",
    "DeviceStore",
    "HostStore",
    "LRURowCache",
    "MmapStore",
    "StagedCohort",
    "available_stores",
    "build_store",
    "build_streamer",
    "register",
]
