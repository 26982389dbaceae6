"""Count Sketch — the port of ``commefficient_tpu/ops/countsketch.py``.

The geometry and hashes are the reference's, integer for integer (pinned by
tests/test_torch_countsketch.py), because the BANDED layout is semantics,
not an optimization: chunk q of m coordinates hashes its within-chunk
offsets into a window of V = band * stride buckets starting at q * stride,
so neighbouring windows overlap and each coordinate collides within ~V
buckets. The reference's module docstring records that other layouts change
training (the feedback loop diverges with disjoint pools), so the port keeps
this one and does not swap in csvec's classic layout. Before any row layout,
one seed-derived permutation of ``sblock``-sized blocks scrambles the
vector; each row then riffles it by a distinct prime factor.

The entry points (``sketch_vec``, ``estimate_all``, ``estimate_at`` and
what is built on them) run through ``ops/cuda/countsketch.py``: the CUDA
kernels on a CUDA tensor, their plain PyTorch versions on a CPU tensor.
For ``sketch_vec`` the scramble stays outside the kernel as a torch
gather, as the reference keeps it outside its Pallas kernels;
``estimate_all``'s kernel writes its estimates in original order itself
(the unscramble fused), ``estimate_at``'s does the scramble lookup, and
``estimate_at_range`` walks a coordinate range in scrambled order.
``sketch_sparse`` scatters its pairs into a [d] vector and sketches that,
so no table bucket is summed by float atomics.

The bf16 forms follow the reference's einsum backend: ``spec.dtype``
(the operand) rounds each signed value to bf16 before the f32 sums of
``sketch_vec`` and each f32 table entry before ``estimate_all``'s
estimate; ``spec.table_dtype`` (the storage) rounds only the finished
table; ``estimate_at`` widens a bf16 table and never rounds; and
``sketch_sparse`` never rounds its f32 values (the reference scatters
them in f32), taking its storage type from the caller.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from commefficient_tpu_torch.ops.cuda.countsketch import (
    estimate_at as estimate_at_kernel,
)
from commefficient_tpu_torch.ops.cuda.countsketch import (
    estimate_at_range as estimate_at_range_kernel,
)
from commefficient_tpu_torch.ops.cuda.countsketch import (
    estimate_all_slices,
    estimate_median,
    median_rows,
    sketch_rows,
)
from commefficient_tpu_torch.ops.cuda.countsketch import (
    sketch_segment as sketch_segment_kernel,
)
from commefficient_tpu_torch.ops.cuda.index_math import fast_divisor
from commefficient_tpu_torch.ops import topk as _topk
from commefficient_tpu_torch.ops.topk import (
    topk_dense,
    topk_sparsify,
    topk_threshold_dense,
)

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF
_MERSENNE_P = 2**31 - 1


# -- hashes ------------------------------------------------------------------


def _poly4_eval(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """((c0 x^3 + c1 x^2 + c2 x + c3) mod p) for uint64 x < p — Horner with
    every intermediate < 2^62, exact in uint64 (host reference)."""
    if x.size and int(x.max()) >= _MERSENNE_P:
        raise ValueError(
            f"poly4 hash input {int(x.max())} >= p=2^31-1; the 4-universal "
            "family is only defined over GF(p) — use hash_family='fmix32' "
            "at this scale"
        )
    p = np.uint64(_MERSENNE_P)
    acc = np.zeros_like(x) + coeffs[0]
    for a in coeffs[1:]:
        acc = (acc * x + a) % p
    return acc


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split c in 16-bit halves
    so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def mix32(x: torch.Tensor, key: int) -> torch.Tensor:
    """murmur3 fmix32 with a key fold on int64 tensors holding uint32
    values — bit-identical to the reference's ``_mix32``."""
    x = (x ^ (int(key) & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def poly4(x: torch.Tensor, coeffs) -> torch.Tensor:
    """The degree-3 Mersenne-31 polynomial on int64 tensors (x < p):
    bit-identical to the host ``_poly4_eval``."""
    acc = torch.full_like(x, int(coeffs[0]))
    for a in coeffs[1:]:
        acc = (acc * x + int(a)) % _MERSENNE_P
    return acc


def _mix32_np(x: np.ndarray, key: int) -> np.ndarray:
    x = x.astype(np.uint32) ^ np.uint32(key)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(_M1)
        x ^= x >> np.uint32(13)
        x *= np.uint32(_M2)
        x ^= x >> np.uint32(16)
    return x


# -- geometry ----------------------------------------------------------------


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def _next_prime_geq(n: int) -> int:
    n = max(n, 2)
    while not _is_prime(n):
        n += 1
    return n


def _ceil_mult(x: int, q: int) -> int:
    return -(-x // q) * q


@functools.lru_cache(maxsize=None)
def _riffle_factors(d: int, m: int, r: int) -> tuple:
    """Per-row riffle factors (distinct primes with pairwise distinct padded
    lattice spacings) — the reference's rule, see its docstring."""
    nc0 = max(1, -(-d // m))

    def lattice(f: int) -> int:
        return -(-nc0 // f)

    def pick(target: int, fs: list, used_g: set) -> int:
        f = _next_prime_geq(max(2, target))
        for _ in range(10_000):
            if f not in fs and lattice(f) not in used_g:
                return f
            f = _next_prime_geq(f + 1)
            if lattice(f) <= 1 and 1 in used_g:
                break
        f = _next_prime_geq(max(2, target))
        while f in fs:
            f = _next_prime_geq(f + 1)
        return f

    fs = [1]
    used_g = {lattice(1)}
    if r == 1:
        return tuple(fs)
    if nc0 >= m:
        targets = [max(2, int(round(m ** 0.5)))]
        g = 2
        for _ in range(2, r):
            targets.append(max(2, nc0 // g))
            g = _next_prime_geq(g + 1)
    else:
        targets = [
            max(2, int(round(nc0 ** (row / max(r - 1, 1)))))
            for row in range(1, r)
        ]
    for t in targets:
        if 0.5 < (m * t) / d < 1.0:
            t = nc0
        f = pick(t, fs, used_g)
        fs.append(f)
        used_g.add(lattice(f))
    return tuple(fs)


@functools.lru_cache(maxsize=None)
def _scramble_perms(d_eff: int, block: int, seed: int):
    """(sperm, inv_sperm) over the d_eff/block blocks (seed-derived)."""
    nb = d_eff // block
    key = (seed * 2654435761) & _MASK32
    sperm = np.argsort(_mix32_np(np.arange(nb, dtype=np.uint32), key),
                       kind="stable").astype(np.int32)
    inv = np.empty_like(sperm)
    inv[sperm] = np.arange(nb, dtype=np.int32)
    return sperm, inv


# kernel row parameters, one int64 row per sketch row (csrc/countsketch.cu)
RP_KEY_SLOT, RP_KEY_SIGN, RP_CSLOT, RP_CSIGN = 0, 1, 2, 6
RP_F, RP_G, RP_M, RP_S, RP_V, RP_NC, RP_ROWLEN, RP_PTR, RP_OFF = range(10, 19)
RP_SBLOCK = 19
# (multiplier, shift) pairs of index_math.fast_divisor, in this order
RP_DIV = 20
DIVISORS = ("G", "f", "m", "V", "s", "mq1", "mq", "sblock")
RP_COUNT = RP_DIV + 2 * len(DIVISORS)


SKETCH_DTYPES = (torch.float32, torch.bfloat16)


@dataclass(frozen=True)
class CountSketch:
    """Static spec of a Count Sketch: the reference's fields (its
    ``backend`` is the tensor's device here). ``c`` is a TARGET column
    count; ``c_actual`` is the realized table width. The derived geometry
    integers are computed once per spec and cached on it (the kernel
    wrappers read them on every launch; recomputing ``c_actual`` costs
    ~0.1 ms of Python).

    ``dtype`` is the OPERAND type: bfloat16 rounds each signed value to
    bf16 before the f32 accumulation of ``sketch_vec``, and each table
    entry to bf16 before ``estimate_all``'s estimate (the reference's
    einsum operands). ``table_dtype`` is the STORAGE type of the tables
    ``sketch_vec`` returns (the sums stay f32; only the final table is
    rounded). Neither shapes the layout, so neither takes part in
    equality: specs that differ only in them share every cached geometry
    and kernel plan."""

    d: int
    c: int
    r: int
    num_blocks: int = 1
    seed: int = 42
    m: Optional[int] = None
    scramble_block: Optional[int] = None
    band: int = 16
    hash_family: str = "fmix32"
    dtype: torch.dtype = field(default=torch.float32, compare=False)
    table_dtype: torch.dtype = field(default=torch.float32, compare=False)

    def __post_init__(self):
        if self.hash_family not in ("fmix32", "poly4"):
            raise ValueError(f"hash_family must be fmix32|poly4, got "
                             f"{self.hash_family!r}")
        for name in ("dtype", "table_dtype"):
            if getattr(self, name) not in SKETCH_DTYPES:
                raise ValueError(f"{name} must be torch.float32 or "
                                 f"torch.bfloat16, got {getattr(self, name)}")
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got "
                             f"{self.num_blocks}")

    @functools.cached_property
    def sblock(self) -> int:
        if self.scramble_block is not None:
            if (not isinstance(self.scramble_block, (int, np.integer))
                    or isinstance(self.scramble_block, bool)):
                raise TypeError(
                    f"scramble_block must be an int (got "
                    f"{self.scramble_block!r}); it is layout arithmetic")
            return int(self.scramble_block)
        return min(64, max(8, self.chunk_m // 64))

    @functools.cached_property
    def d_eff(self) -> int:
        b = self.sblock
        return _ceil_mult(self.d, b) if b else self.d

    @functools.cached_property
    def chunk_m(self) -> int:
        if self.m is not None:
            return min(self.m, _ceil_mult(self.d, 8))
        m = 512
        while m < 32768 and self.d / m > self.c / 256:
            m *= 2
        return min(m, _ceil_mult(self.d, 8))

    @functools.cached_property
    def nc(self) -> int:
        return max(self._nc_row(r) for r in range(self.r))

    def _factor(self, row: int) -> int:
        return _riffle_factors(self.d, self.chunk_m, self.r)[row]

    def _L_row(self, row: int) -> int:
        return _ceil_mult(self.d_eff, self.chunk_m * self._factor(row))

    def _nc_row(self, row: int) -> int:
        return self._L_row(row) // self.chunk_m

    def u_row(self, row: int) -> int:
        return max(1, min(self.band or 1, self._nc_row(row)))

    def s_row(self, row: int) -> int:
        raw = max(1, round(self.c / (self._nc_row(row) + self.u_row(row) - 1)))
        return max(8, round(raw / 8) * 8)

    def V_row(self, row: int) -> int:
        return self.u_row(row) * self.s_row(row)

    @property
    def s(self) -> int:
        return self.s_row(0)

    @functools.cached_property
    def c_actual(self) -> int:
        return max((self._nc_row(r) + self.u_row(r) - 1) * self.s_row(r)
                   for r in range(self.r))

    @functools.cached_property
    def table_shape(self) -> tuple:
        return (self.r, self.c_actual)

    # -- per-row hash ingredients -------------------------------------------
    def _row_key(self, row: int) -> int:
        x = (row ^ self.seed) & _MASK32
        for _ in range(2):
            x = ((x ^ (x >> 16)) * _M1) & _MASK32
        return x ^ _GOLDEN

    def _poly4_coeffs(self, row: int, purpose: int) -> np.ndarray:
        """[4] uint64 in [1, p): purpose 0 = bucket slots, 1 = signs."""
        # a pure function of (seed, row, purpose): the same at capture and
        # at every replay, and no device value is read
        # lint: allow[traced-purity] seed-derived host hash coefficients
        rng = np.random.default_rng(
            np.random.SeedSequence([int(self.seed) & 0x7FFFFFFF, row, purpose]))
        return rng.integers(1, _MERSENNE_P, size=4).astype(np.uint64)

    def slot_hash(self, row: int, off: torch.Tensor) -> torch.Tensor:
        """In-window bucket of within-chunk offsets ``off`` (int64)."""
        if self.hash_family == "poly4":
            h = poly4(off, self._poly4_coeffs(row, 0))
        else:
            h = mix32(off, self._row_key(row))
        return h % self.V_row(row)

    def sign_bits(self, row: int, spos: torch.Tensor) -> torch.Tensor:
        """Sign bit (1 = negative) of scrambled positions ``spos``."""
        if self.hash_family == "poly4":
            h = poly4(spos, self._poly4_coeffs(row, 1))
        else:
            h = mix32(spos, self._row_key(row) ^ _GOLDEN)
        return h & 1

    def inverse_block_perm(self) -> Optional[np.ndarray]:
        """[d_eff / sblock] int32: the scrambled block of each original
        block (None when the spec does not scramble)."""
        b = self.sblock
        return _scramble_perms(self.d_eff, b, self.seed)[1] if b else None

    def scrambled_pos(self, idx: torch.Tensor) -> torch.Tensor:
        """Original coordinates (int64) -> their positions in scrambled
        space."""
        b = self.sblock
        if not b:
            return idx
        inv = _perm(self.d_eff, b, self.seed, True, str(idx.device))
        return inv[idx // b] * b + idx % b

    def scrambled_cols_signs(self, row: int, spos: torch.Tensor):
        """(column int64, sign f32) of scrambled positions ``spos``: riffle
        -> chunk/offset -> ``chunk * s + slot(offset)``."""
        f, L, m = self._factor(row), self._L_row(row), self.chunk_m
        G = L // f
        pos = (spos % G) * f + spos // G
        slots = self.slot_hash(row, torch.arange(m, device=spos.device))
        cols = (pos // m) * self.s_row(row) + slots[pos % m]
        sign = 1.0 - 2.0 * self.sign_bits(row, spos).to(torch.float32)
        return cols, sign

    def kernel_divisors(self, row: int) -> dict:
        """``{name: (divisor, largest dividend)}`` for every runtime
        division of the CUDA kernels at ``row`` (``DIVISORS`` order):
        G, f and m divide riffled or scrambled positions (< L), V a 32-bit
        hash, s a column bound, ``mq1 = m div f + 1`` and ``mq = max(m div
        f, 1)`` a stage slot (< m), sblock an original coordinate."""
        f, L, m = self._factor(row), self._L_row(row), self.chunk_m
        s, mq = self.s_row(row), m // f
        return {"G": (L // f, L - 1), "f": (f, L - 1), "m": (m, L - 1),
                "V": (self.V_row(row), 2**32 - 1),
                "s": (s, self.c_actual + s), "mq1": (mq + 1, m - 1),
                "mq": (max(mq, 1), m - 1),
                "sblock": (self.sblock or 1, self.d_eff - 1)}

    def kernel_row_params(self) -> np.ndarray:
        """[r, RP_COUNT] int64 per-row constants for the CUDA kernels; the
        CSR bases assume ``csr_tables`` concatenated row after row."""
        P = np.zeros((self.r, RP_COUNT), np.int64)
        ptr_base = 0
        for row in range(self.r):
            f, L = self._factor(row), self._L_row(row)
            u, s = self.u_row(row), self.s_row(row)
            key = self._row_key(row)
            P[row, RP_KEY_SLOT] = key
            P[row, RP_KEY_SIGN] = key ^ _GOLDEN
            P[row, RP_CSLOT:RP_CSLOT + 4] = self._poly4_coeffs(row, 0)
            P[row, RP_CSIGN:RP_CSIGN + 4] = self._poly4_coeffs(row, 1)
            P[row, RP_F], P[row, RP_G], P[row, RP_M] = f, L // f, self.chunk_m
            P[row, RP_S], P[row, RP_V] = s, u * s
            P[row, RP_NC] = L // self.chunk_m
            P[row, RP_ROWLEN] = (L // self.chunk_m + u - 1) * s
            P[row, RP_PTR], P[row, RP_OFF] = ptr_base, row * self.chunk_m
            P[row, RP_SBLOCK] = self.sblock
            divs = self.kernel_divisors(row)
            for k, name in enumerate(DIVISORS):
                P[row, RP_DIV + 2 * k:RP_DIV + 2 * k + 2] = fast_divisor(
                    *divs[name])
            ptr_base += u * s + 1
        return P

    def csr_tables(self, device) -> tuple:
        """(ptr int32 [sum_r (V_r + 1)], off int32 [r * m]): per row, the
        within-chunk offsets grouped by slot (ascending offsets within a
        slot) and the slot -> start pointers — the inverse of the slot hash
        that the sketch kernel gathers through."""
        ptrs, offs = [], []
        m = self.chunk_m
        for row in range(self.r):
            slots = self.slot_hash(row, torch.arange(m, device=device))
            offs.append(torch.argsort(slots, stable=True))
            counts = torch.bincount(slots, minlength=self.V_row(row))
            ptrs.append(torch.cat([counts.new_zeros(1),
                                   torch.cumsum(counts, 0)]))
        return (torch.cat(ptrs).to(torch.int32).contiguous(),
                torch.cat(offs).to(torch.int32).contiguous())


def _check_poly4_field(spec: CountSketch) -> None:
    """poly4 is defined over GF(2^31 - 1): every hashed position must be
    below p (the reference's pallas-backend guard)."""
    if spec.hash_family != "poly4":
        return
    worst = max(spec._L_row(r) for r in range(spec.r))
    if worst >= _MERSENNE_P:
        raise ValueError(
            f"poly4 layout position bound {worst} >= p=2^31-1; the "
            "4-universal family is only defined over GF(p) — use "
            "hash_family='fmix32' at this scale")


@functools.lru_cache(maxsize=16)
def _perm(d_eff: int, block: int, seed: int, inverse: bool,
          device: str) -> torch.Tensor:
    sperm, inv = _scramble_perms(d_eff, block, seed)
    return torch.from_numpy((inv if inverse else sperm).astype(np.int64)).to(
        device)


def _scramble(spec: CountSketch, v: torch.Tensor) -> torch.Tensor:
    """[d] -> [d_eff] scrambled (block-permuted) vector."""
    b = spec.sblock
    if not b:
        return v
    vp = torch.nn.functional.pad(v, (0, spec.d_eff - spec.d))
    idx = _perm(spec.d_eff, b, spec.seed, False, str(v.device))
    return vp.reshape(-1, b)[idx].reshape(spec.d_eff)


def _unscramble(spec: CountSketch, v_s: torch.Tensor) -> torch.Tensor:
    """[d_eff] scrambled -> [d] original order."""
    b = spec.sblock
    if not b:
        return v_s[: spec.d]
    idx = _perm(spec.d_eff, b, spec.seed, True, str(v_s.device))
    return v_s.reshape(-1, b)[idx].reshape(spec.d_eff)[: spec.d]


# -- entry points --------------------------------------------------------------


def _table(t: torch.Tensor) -> torch.Tensor:
    """A table as the kernels take it: f32 or bf16 (any other float type
    goes to f32), contiguous."""
    if t.dtype not in SKETCH_DTYPES:
        t = t.to(torch.float32)
    return t.contiguous()


def sketch_vec(spec: CountSketch, v: torch.Tensor) -> torch.Tensor:
    """Sketch a dense [d] vector into an [r, c_actual] table of
    ``spec.table_dtype``, its signed values rounded to ``spec.dtype`` and
    summed in f32 (K1). Linear: ``sketch_vec(a + b) == sketch_vec(a) +
    sketch_vec(b)`` up to f32 summation order (and, for bf16 tables, the
    rounding of the three tables)."""
    _check_poly4_field(spec)
    return sketch_rows(spec, _scramble(spec, v.to(torch.float32)),
                       operand=spec.dtype, table_dtype=spec.table_dtype)


def estimate_all(spec: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimates for all d coordinates, in original order
    (the gather, the median and the unscramble in one kernel, K2), each
    table entry read as ``spec.dtype`` (a bf16 table widens; an f32 table
    rounds to bf16 when the operand type is bf16).

    ``spec.num_blocks = B > 1`` is the reference's memory trade: the exact
    gather estimate over B coordinate slices of ``blk = ceil(d / B)``, the
    last padded by repeating coordinate ``d - 1`` (``estimate_at_range``'s
    clip), each written into one preallocated ``[d]`` output, so only one
    slice's estimate is live beside it (K4's range form on the card). The
    gather estimate reads the table as ``estimate_at`` does (widened,
    never rounded to ``spec.dtype``), as the reference's blockwise path
    does; at an f32 operand every value equals the one-kernel path's."""
    _check_poly4_field(spec)
    table = _table(table)
    if spec.num_blocks == 1:
        return estimate_median(spec, table, operand=spec.dtype)
    out = torch.empty(spec.d, dtype=torch.float32, device=table.device)
    for start, blk in estimate_all_slices(spec):
        est = estimate_at_range_kernel(spec, table, start, blk)
        out[start:start + blk] = est[:spec.d - start]
        del est
    return out


def _row_cols_signs(spec: CountSketch, idx: torch.Tensor, row: int):
    """(column, sign) of ORIGINAL coordinates ``idx`` for one row."""
    return spec.scrambled_cols_signs(row, spec.scrambled_pos(idx.long()))


def estimate_at(spec: CountSketch, table: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Median-of-rows point estimates at original coordinates ``idx``
    (the fused scramble + gather + median, K4 on a CUDA tensor). A bf16
    table is widened at the read and never rounded to ``spec.dtype``, as
    the reference's gather path reads it."""
    _check_poly4_field(spec)
    return estimate_at_kernel(spec, _table(table),
                              idx.to(torch.int64).contiguous())


def estimate_at_range(spec: CountSketch, table: torch.Tensor, start: int,
                      n: int) -> torch.Tensor:
    """``estimate_at`` at the clipped coordinate range ``min(start +
    arange(n), d - 1)``, with no index array (K4's range form on a CUDA
    tensor): the sharded decode's slice estimate."""
    _check_poly4_field(spec)
    return estimate_at_range_kernel(spec, _table(table), start, n)


def sketch_sparse(spec: CountSketch, idx: torch.Tensor, vals: torch.Tensor,
                  table_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sketch a k-sparse vector given as (indices [k], values [k]); repeats
    accumulate. The pairs are added into a zero [d] vector, which is then
    sketched by K1 in f32 (never rounded to ``spec.dtype``: the
    reference scatters f32 values) into a ``table_dtype`` table (the
    reference's cast of the f32 result): the table's buckets are summed by
    K1 in its fixed order, so the result does not depend on float-atomic
    order. On the card the only order-dependent step is that [d] scatter,
    which is exact whenever each coordinate carries at most one nonzero
    value: the (idx, val) buffers of ``compact_nonzero`` hold distinct
    coordinates plus ``(i, 0.0)`` pads, and adding 0.0 is exact in any
    order."""
    _check_poly4_field(spec)
    return sketch_rows(spec, scrambled_sparse(spec, idx, vals),
                       operand=torch.float32, table_dtype=table_dtype)


def scrambled_sparse(spec: CountSketch, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """The (indices, values) pairs added into a zero f32 [d] vector and
    scrambled to [d_eff]: what ``sketch_sparse`` hands K1."""
    dense = torch.zeros(spec.d, dtype=torch.float32, device=vals.device)
    dense.index_add_(0, idx.to(torch.int64), vals.to(torch.float32))
    return _scramble(spec, dense)


def sketch_segment(spec: CountSketch, offset: int, vals: torch.Tensor,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sketch the contiguous original-order segment ``[offset, offset +
    n)`` given its values (any shape; raveled) into an f32 table: added
    into ``table`` in place when given (f32 ``[r, c_actual]``), else into
    a new zero table. The values are f32 and never rounded to
    ``spec.dtype``, as the reference's ``sketch_segment`` scatters them.
    By linearity the sum of every leaf's segment sketch is the sketch of
    the whole flat vector, which never has to exist (K1's segment form on
    a CUDA tensor: no ``[d]`` buffer, no float atomics)."""
    _check_poly4_field(spec)
    flat = vals.reshape(-1).to(torch.float32).contiguous()
    if table is None:
        table = torch.zeros(spec.table_shape, dtype=torch.float32,
                            device=flat.device)
    return sketch_segment_kernel(spec, int(offset), flat, table)


class SketchGradTap(torch.autograd.Function):
    """``SketchGradTap.apply(leaf, table, spec, offset)``: the identity on
    ``leaf`` whose backward adds the segment sketch of the leaf's cotangent
    (``sketch_segment`` at the leaf's ravel offset) into ``table``'s own
    storage, and gives ``leaf`` its cotangent only if the leaf requires a
    gradient (the reference's ``sketch_grad_tap``, whose backward returns
    that sketch as the table's cotangent). Thread every parameter leaf
    through a tap sharing one zero f32 ``table`` that requires a gradient
    and run the backward with respect to it (``torch.autograd.grad(loss,
    [table], allow_unused=True)``: no tap returns a gradient for it): the
    taps add, in the fixed order of autograd's backward, the sketch of the
    whole flat gradient into the one table, while the parameters
    themselves are not differentiated, so the flat ``[D]`` gradient is
    never formed and no table a leaf is allocated. ``done``, when given,
    is called with no argument after the backward has added the leaf's
    sketch (the layerwise overlap counts a group's leaves with it). A tap
    with ``spec=None`` adds nothing and still calls ``done`` (a leaf whose
    gradient another rank of a model or seq group contributes)."""

    @staticmethod
    def forward(ctx, leaf, table, spec, offset: int, done=None):
        ctx.spec, ctx.offset, ctx.table = spec, int(offset), table
        ctx.done = done
        return leaf.view_as(leaf)

    @staticmethod
    def backward(ctx, ct):
        if ctx.spec is not None:
            sketch_segment(ctx.spec, ctx.offset, ct, ctx.table.detach())
        if ctx.done is not None:
            ctx.done()
        return ((ct if ctx.needs_input_grad[0] else None), None, None, None,
                None)


def _median_over_rows(per_row: torch.Tensor) -> torch.Tensor:
    """The median of an ``[r]`` f32 vector as a 0-d tensor: K3 on a
    ``[r, 1]`` stack (its plain network on the CPU), exact for odd r and
    the mean of the middle two for even r, as ``jnp.median``; a NaN
    anywhere makes it NaN (the compare-exchanges propagate it)."""
    return median_rows(per_row[:, None].contiguous())[0]


def table_sqnorm_estimate(table: torch.Tensor) -> torch.Tensor:
    """AMS estimate of ``||v||^2`` from v's ``[r, c]`` table: each row's
    sum of squares is an unbiased estimate (the signs are 4-universal) and
    the median over rows tames collisions. The rows are reduced in f32, so
    a bf16 table's sum does not lose the estimate to rounding. One read of
    the table, no estimate pass and no ``[d]`` transient: the sketch
    mode's norm diagnostics."""
    return _median_over_rows(torch.linalg.vector_norm(
        table, dim=1, dtype=torch.float32).square())


def l2_estimate(spec: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Estimate of the sketched vector's L2 norm: the median over rows of
    the row norms (``CSVec.l2estimate``), by the same route."""
    return _median_over_rows(torch.linalg.vector_norm(
        table, dim=1, dtype=torch.float32))


def unsketch_sparse(spec: CountSketch, table: torch.Tensor, k: int):
    """Top-k heavy hitters by |estimate| as (indices [k], values [k]), in
    ``lax.top_k`` order (ties go to the lower index; ``topk_method=
    'approx'`` runs it too, see ``ops/topk.py``)."""
    est = estimate_all(spec, table)
    vals, idx = topk_sparsify(est, k)
    return idx, vals


def topk_scatter(v: torch.Tensor, k: int) -> torch.Tensor:
    """The exact decode's selection: ``topk_sparsify``'s k entries of flat
    ``v`` scattered into a dense zero vector. While a CUDA graph is being
    captured (the scan engine's rounds) it is ``topk_dense``, the same set
    with shapes that do not depend on the data: ``topk_sparsify``'s
    ``nonzero`` reads a count back to the host, which a graph cannot hold.
    Both give the same dense vector bit for bit."""
    if _topk.graph_capturing(v):
        return topk_dense(v, k)
    vals, idx = topk_sparsify(v, k)
    out = torch.zeros_like(v)
    out[idx] = vals
    return out


def unsketch(spec: CountSketch, table: torch.Tensor, k: int) -> torch.Tensor:
    """``unsketch_sparse`` as a dense [d] vector with k nonzeros."""
    return topk_scatter(estimate_all(spec, table), k)


def unsketch_dense(spec: CountSketch, table: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Heavy hitters as a dense [d] vector with AT MOST k nonzeros, by the
    bisected magnitude threshold (``topk_threshold_dense``) rather than a
    sort: ties at the threshold are dropped, not broken."""
    return topk_threshold_dense(estimate_all(spec, table), k)
