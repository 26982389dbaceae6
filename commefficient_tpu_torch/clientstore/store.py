"""Per-client state stores: where the ``[num_clients, D]`` rows live (the
port's copy of ``commefficient_tpu/clientstore/store.py``).

FetchSGD's baselines keep state per client (local momentum's velocity,
local error feedback's error), while each round touches only its W
participants' rows. A ``ClientStateStore`` owns one such bank outside the
round and gives the round exactly the cohort's view:

  * ``gather_rows(ids, out=None) -> [n, D]``: the cohort's rows, a float32
    COPY (or written into ``out``, a caller's buffer such as a pinned
    staging slot), safe to copy to the card while the bank keeps changing;
  * ``scatter_rows(ids, rows)``: the round's updated rows written back; a
    repeated id takes its LAST row, as numpy's fancy assignment does.

Three kinds behind a registry (``--client_store``, mirrored by
``utils.config.CLIENT_STORES``):

  * ``device``: the bank as a torch tensor on an explicit device. A session
    with ``client_store='device'`` builds no store (its banks are
    ``FedState`` leaves); the class is registered so the contract tests
    cover every kind;
  * ``host``: a numpy bank in host RAM: the population is bounded by host
    memory, not by the card's;
  * ``mmap``: the same in a file, each row read and written through its
    own ``np.memmap``: bounded by disk, and only the rows a run writes
    take blocks (a zero bank is a sparse file). A named ``path`` is
    reopened with its content when its size matches; ``""`` uses a
    temporary file unlinked on ``close``.

numpy and the standard library only, but for the device store's torch.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

REGISTRY: dict = {}


def register(name: str):
    """Class decorator: register a store kind under ``name``."""

    def deco(cls):
        if name in REGISTRY:
            raise ValueError(f"duplicate client store {name!r}")
        REGISTRY[name] = cls
        cls.kind = name
        return cls

    return deco


def available_stores() -> tuple:
    """The registered kinds, sorted (``config.CLIENT_STORES`` mirrors
    them; tests/test_torch_clientstore.py pins the two equal)."""
    return tuple(sorted(REGISTRY))


def build_store(kind: str, *, num_rows: int, row_dim: int, path: str = "",
                device="cpu") -> "ClientStateStore":
    """A store of ``kind``; ``device`` is read by the device store only."""
    if kind not in REGISTRY:
        raise ValueError(
            f"unknown client store {kind!r}; available: {available_stores()}")
    return REGISTRY[kind](num_rows=num_rows, row_dim=row_dim, path=path,
                          device=device)


def last_wins(ids, rows):
    """``(ids, rows)`` with each repeated id kept once, at its LAST row:
    the order-free form of numpy's last-write-wins fancy assignment."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if np.unique(ids).size == ids.size:
        return ids, rows
    rev = ids[::-1]
    _, first = np.unique(rev, return_index=True)
    keep = np.sort(ids.size - 1 - first)
    return ids[keep], rows[keep]


class ClientStateStore:
    """The store contract: a bank of ``[num_rows, row_dim]`` float32 rows,
    zero at the start (the device bank's ``torch.zeros``)."""

    kind = "abstract"

    def __init__(self, *, num_rows: int, row_dim: int, path: str = "",
                 device="cpu"):
        if num_rows < 1 or row_dim < 1:
            raise ValueError(
                f"store shape must be positive, got [{num_rows}, {row_dim}]")
        self.num_rows = int(num_rows)
        self.row_dim = int(row_dim)

    # -- the cohort contract ----------------------------------------------
    def gather_rows(self, ids, out=None) -> np.ndarray:
        """``[len(ids), row_dim]`` float32 copy of the rows at ``ids``,
        written into ``out`` when given (and returned)."""
        raise NotImplementedError

    def scatter_rows(self, ids, rows) -> None:
        """Write ``rows`` at ``ids`` (a repeated id: its last row)."""
        raise NotImplementedError

    def _ids(self, ids) -> np.ndarray:
        """``ids`` as int64 row indices, each checked to lie in the
        bank."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_rows):
            raise IndexError(f"row ids must lie in [0, {self.num_rows})")
        return ids

    # -- the whole bank (checkpoint, rollback vault) -----------------------
    def array(self) -> np.ndarray:
        """The ``[num_rows, row_dim]`` bank; may be a live view, so a
        caller that keeps it copies it (the vault does)."""
        raise NotImplementedError

    def _checked(self, arr) -> np.ndarray:
        a = np.asarray(arr, dtype=np.float32)
        if a.shape != (self.num_rows, self.row_dim):
            raise ValueError(
                f"bank shape mismatch: store is [{self.num_rows}, "
                f"{self.row_dim}], got {a.shape}")
        return a

    def load(self, arr) -> None:
        """Overwrite the whole bank (checkpoint restore, vault
        rollback)."""
        self.array()[...] = self._checked(arr)

    def flush(self) -> None:
        """Persist written rows (mmap); nothing for a resident bank."""

    def close(self) -> None:
        """Release the bank; the store is unusable after."""


@register("host")
class HostStore(ClientStateStore):
    """A numpy bank in host RAM."""

    def __init__(self, *, num_rows: int, row_dim: int, path: str = "",
                 device="cpu"):
        super().__init__(num_rows=num_rows, row_dim=row_dim)
        self._bank = np.zeros((num_rows, row_dim), np.float32)

    def gather_rows(self, ids, out=None) -> np.ndarray:
        ids = self._ids(ids)
        if out is None:
            return self._bank[ids]
        # checked by _ids: "clip" then writes straight into out, where
        # "raise" would gather into a temporary first
        return np.take(self._bank, ids, axis=0, out=out, mode="clip")

    def scatter_rows(self, ids, rows) -> None:
        ids, rows = last_wins(ids, np.asarray(rows, dtype=np.float32))
        self._bank[ids] = rows

    def array(self) -> np.ndarray:
        return self._bank


@register("mmap")
class MmapStore(ClientStateStore):
    """A memory-mapped bank: disk bounds the population, and the file
    holds blocks only for the rows written (it is created sparse). A
    named ``path`` whose size matches is reopened with its content;
    ``""`` makes a temporary file that ``close`` unlinks.

    Each row is read and written through a mapping of that row alone
    (``np.memmap`` at the row's offset); only ``array()`` maps the whole
    bank. A mapping of the whole file costs nothing on a Linux file
    system, where only the touched pages fault in, but a file system may
    populate a shared file mapping in full at its first fault (gVisor's
    9p mounts do), which for a bank of 10,000 ResNet-9 clients is 263 GB
    of page cache."""

    def __init__(self, *, num_rows: int, row_dim: int, path: str = "",
                 device="cpu"):
        super().__init__(num_rows=num_rows, row_dim=row_dim)
        self._owns_file = not path
        if not path:
            fd, path = tempfile.mkstemp(prefix="clientstore_", suffix=".bank")
            os.close(fd)
        self.path = path
        nbytes = num_rows * row_dim * 4
        reopen = os.path.exists(path) and os.path.getsize(path) == nbytes
        self._file = open(path, "r+b" if reopen else "w+b")
        if not reopen:
            self._file.truncate(nbytes)  # sparse: no block is written
        self._whole = None  # array()'s mapping, made on demand

    def _row(self, i: int) -> np.memmap:
        return np.memmap(self._file, dtype=np.float32, mode="r+",
                         offset=int(i) * self.row_dim * 4,
                         shape=(self.row_dim,))

    def gather_rows(self, ids, out=None) -> np.ndarray:
        ids = self._ids(ids)
        if out is None:
            out = np.empty((ids.size, self.row_dim), np.float32)
        for k, i in enumerate(ids):
            out[k] = self._row(i)
        return out

    def scatter_rows(self, ids, rows) -> None:
        ids, rows = last_wins(ids, np.asarray(rows, dtype=np.float32))
        for i, row in zip(ids, rows):
            self._row(i)[...] = row

    def array(self) -> np.ndarray:
        if self._whole is None:
            self._whole = np.memmap(self._file, dtype=np.float32, mode="r+",
                                    shape=(self.num_rows, self.row_dim))
        return self._whole

    def flush(self) -> None:
        if self._whole is not None:
            self._whole.flush()
        self._file.flush()
        os.fsync(self._file.fileno())  # the rows' mappings are gone

    def close(self) -> None:
        if self._file is not None:
            self.flush()
            self._whole = None  # the mapping goes before the file
            self._file.close()
            self._file = None
        if self._owns_file and os.path.exists(self.path):
            os.unlink(self.path)


@register("device")
class DeviceStore(ClientStateStore):
    """The bank as a float32 torch tensor on ``device``. A session never
    builds it (``client_store='device'`` keeps the banks in ``FedState``);
    it is here so the contract holds for every ``--client_store`` kind."""

    def __init__(self, *, num_rows: int, row_dim: int, path: str = "",
                 device="cpu"):
        super().__init__(num_rows=num_rows, row_dim=row_dim)
        self.device = torch.device(device)
        self._bank = torch.zeros(num_rows, row_dim, dtype=torch.float32,
                                 device=self.device)

    def _index(self, ids) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, np.int64).reshape(-1)).to(
            self.device)

    def gather_rows(self, ids, out=None) -> np.ndarray:
        rows = self._bank[self._index(ids)].cpu().numpy()
        if out is None:
            return rows
        out[...] = rows
        return out

    def scatter_rows(self, ids, rows) -> None:
        ids, rows = last_wins(ids, np.asarray(rows, dtype=np.float32))
        self._bank.index_copy_(0, self._index(ids),
                               torch.from_numpy(rows).to(self.device))

    def array(self) -> np.ndarray:
        return self._bank.cpu().numpy()

    def load(self, arr) -> None:
        self._bank.copy_(torch.from_numpy(np.array(self._checked(arr))))
