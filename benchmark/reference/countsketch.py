"""CountSketch as FetchSGD's server keeps it, in plain PyTorch: the table
of a ``[d]`` vector and the median-of-rows estimate of every coordinate.

The layout is part of the configuration's semantics, so it is worked out
here again from the seed and the sizes: the vector, zero-padded to
``d_eff`` (a multiple of the scramble block), has its blocks permuted by
a seed-keyed hash; each row then riffles the scrambled vector by its own
prime factor f (position p of ``G = L / f`` columns goes to ``(p mod G)
* f + p div G``), cuts it into chunks of m coordinates, and hashes each
within-chunk offset into a banded window of ``V = u * s`` buckets that
starts at ``chunk * s``; the sign is a hash of the scrambled position.
Hashes are murmur3's fmix32 with the row's key folded in. Sums are
float32 ``index_add_``; the estimate is the median over the rows of the
signed bucket values (the mean of the middle two for an even r)."""

from __future__ import annotations

import numpy as np
import torch

M1, M2, GOLDEN, MASK32 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor, key: int) -> torch.Tensor:
    """murmur3's finalizer of ``x ^ key`` on int64 tensors of uint32."""
    x = (x ^ (int(key) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def _prime_geq(n: int) -> int:
    n = max(n, 2)
    while not _is_prime(n):
        n += 1
    return n


def _ceil_mult(x: int, q: int) -> int:
    return -(-x // q) * q


class Geometry:
    """The table's geometry for ``d`` coordinates, ``c`` requested
    columns, ``r`` rows, the hash seed and the window's band."""

    def __init__(self, d: int, c: int, r: int, seed: int, band: int = 16):
        self.d, self.c, self.r, self.seed, self.band = d, c, r, seed, band
        m = 512
        while m < 32768 and d / m > c / 256:
            m *= 2
        self.m = min(m, _ceil_mult(d, 8))
        self.sblock = min(64, max(8, self.m // 64))
        self.d_eff = _ceil_mult(d, self.sblock)
        self.factors = self._factors()
        self._inv = {}
        self.c_actual = max((self.nc(i) + self.u(i) - 1) * self.s(i)
                            for i in range(r))

    def _factors(self):
        """Distinct primes, one a row (1 for row 0), whose column lattices
        ``ceil(nc0 / f)`` differ pairwise."""
        d, m, r = self.d, self.m, self.r
        nc0 = max(1, -(-d // m))

        def lattice(f):
            return -(-nc0 // f)

        def pick(target, fs, used):
            f = _prime_geq(max(2, target))
            for _ in range(10_000):
                if f not in fs and lattice(f) not in used:
                    return f
                f = _prime_geq(f + 1)
                if lattice(f) <= 1 and 1 in used:
                    break
            f = _prime_geq(max(2, target))
            while f in fs:
                f = _prime_geq(f + 1)
            return f

        fs, used = [1], {lattice(1)}
        if r == 1:
            return fs
        if nc0 >= m:
            targets = [max(2, int(round(m ** 0.5)))]
            g = 2
            for _ in range(2, r):
                targets.append(max(2, nc0 // g))
                g = _prime_geq(g + 1)
        else:
            targets = [max(2, int(round(nc0 ** (i / max(r - 1, 1)))))
                       for i in range(1, r)]
        for t in targets:
            if 0.5 < (m * t) / d < 1.0:
                t = nc0
            f = pick(t, fs, used)
            fs.append(f)
            used.add(lattice(f))
        return fs

    def L(self, i):
        return _ceil_mult(self.d_eff, self.m * self.factors[i])

    def nc(self, i):
        return self.L(i) // self.m

    def u(self, i):
        return max(1, min(self.band or 1, self.nc(i)))

    def s(self, i):
        raw = max(1, round(self.c / (self.nc(i) + self.u(i) - 1)))
        return max(8, round(raw / 8) * 8)

    def key(self, i):
        x = (i ^ self.seed) & MASK32
        for _ in range(2):
            x = ((x ^ (x >> 16)) * M1) & MASK32
        return x ^ GOLDEN

    def _inverse_blocks(self, device) -> torch.Tensor:
        """The scrambled block of each original block, on ``device``."""
        if device in self._inv:
            return self._inv[device]
        nb = self.d_eff // self.sblock
        key = (self.seed * 2654435761) & MASK32
        h = fmix32(torch.arange(nb, dtype=torch.int64), key)
        perm = torch.from_numpy(np.argsort(h.numpy(), kind="stable"))
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(nb)
        self._inv[device] = inv.to(device)
        return self._inv[device]

    def cols_signs(self, i: int, idx: torch.Tensor):
        """Row i's (bucket int64, sign f32) of original coordinates
        ``idx``."""
        b = self.sblock
        spos = self._inverse_blocks(idx.device)[idx // b] * b + idx % b
        f, m = self.factors[i], self.m
        G = self.L(i) // f
        pos = (spos % G) * f + spos // G
        slots = fmix32(torch.arange(m, device=idx.device),
                       self.key(i)) % (self.u(i) * self.s(i))
        cols = (pos // m) * self.s(i) + slots[pos % m]
        sign = 1.0 - 2.0 * (fmix32(spos, self.key(i) ^ GOLDEN) & 1).to(
            torch.float32)
        return cols, sign


def _chunks(d: int, device, n: int = 1 << 25):
    for o in range(0, d, n):
        yield torch.arange(o, min(o + n, d), device=device)


def sketch(geo: Geometry, v: torch.Tensor) -> torch.Tensor:
    """``[r, c_actual]`` float32 table of ``v`` (``[d]``)."""
    v = v.to(torch.float32)
    table = torch.zeros((geo.r, geo.c_actual), dtype=torch.float32,
                        device=v.device)
    for idx in _chunks(geo.d, v.device):
        for i in range(geo.r):
            cols, sign = geo.cols_signs(i, idx)
            table[i].index_add_(0, cols, sign * v[idx])
    return table


def estimate(geo: Geometry, table: torch.Tensor) -> torch.Tensor:
    """``[d]`` median over rows of ``sign * table[row, bucket]``."""
    table = table.to(torch.float32)
    out = torch.empty(geo.d, dtype=torch.float32, device=table.device)
    for idx in _chunks(geo.d, table.device):
        rows = []
        for i in range(geo.r):
            cols, sign = geo.cols_signs(i, idx)
            rows.append(sign * table[i][cols])
        srt = torch.stack(rows).sort(dim=0).values
        h = geo.r // 2
        out[idx] = srt[h] if geo.r % 2 else 0.5 * (srt[h - 1] + srt[h])
    return out
