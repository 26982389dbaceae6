"""Wrappers of the CountSketch CUDA kernels, each beside its plain version.

Every wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, and then:

* on a CPU tensor calls its plain PyTorch version (the tests' path);
* on a CUDA tensor launches its kernel on the current stream and raises if
  the launch returned a CUDA error — there is no fallback.

``launches`` on each wrapper counts kernel launches (never plain-version
calls), so a run can show that its main path went through the kernels.

The wrappers read the spec through its methods (``kernel_row_params``,
``csr_tables``, ``scrambled_cols_signs``, ``scrambled_pos``,
``inverse_block_perm``), so this module needs nothing from
``ops/countsketch.py``, which imports it. The host-side plans of the
kernels' index arithmetic (K1's tile width, K4's range-form block order
and table windows) come from ``index_math``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from commefficient_tpu_torch.ops.cuda import index_math

_FAMILY = {"fmix32": 0, "poly4": 1}
MAX_ROWS = 8  # CS_MAX_ROWS in csrc/countsketch.cu


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_rows(r: int) -> None:
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"the CUDA kernels take 1..{MAX_ROWS} rows, got {r}")


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=8)
def _kernel_geometry(spec, device: str):
    """(row params as a ctypes int64 array, CSR ptr, CSR offsets, K1's tile
    width in strides) for the kernels: built once per (spec, device) from
    the same hash functions as the plain versions, and kept alive here
    while the kernels may read them."""
    if max(spec._L_row(r) for r in range(spec.r)) >= 2**32:
        raise ValueError("the CUDA kernels index the padded layout in "
                         "uint32; this spec's layout exceeds 2^32")
    params = spec.kernel_row_params()
    rows = (ctypes.c_longlong * params.size)(*params.reshape(-1).tolist())
    ptr, off = spec.csr_tables(device)
    tile = index_math.sketch_tile_strides(
        [(spec.chunk_m, spec.s_row(r), spec.V_row(r)) for r in range(spec.r)])
    return rows, ptr, off, tile


@functools.lru_cache(maxsize=2)
def _plain_maps(spec, device: str):
    """Per-row (columns [d_eff] int64, signs [d_eff] f32) of every
    scrambled position, for the plain versions."""
    spos = torch.arange(spec.d_eff, device=device)
    return [spec.scrambled_cols_signs(row, spos) for row in range(spec.r)]


def _median_network(rows) -> torch.Tensor:
    """Median of a list of equal-shape tensors by the all-pairs
    compare-exchange network of ``median_rows_pallas`` (mean of the middle
    two for an even count)."""
    rows = list(rows)
    r = len(rows)
    for a in range(r):
        for b in range(a + 1, r):
            rows[a], rows[b] = (torch.minimum(rows[a], rows[b]),
                                torch.maximum(rows[a], rows[b]))
    if r % 2:
        return rows[r // 2]
    return 0.5 * (rows[r // 2 - 1] + rows[r // 2])


# -- K1: sketch rows ------------------------------------------------------------


def sketch_rows_torch(spec, v_s: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: an ``index_add_`` scatter per row over the
    precomputed columns and signs of every scrambled position."""
    table = torch.zeros(spec.table_shape, dtype=torch.float32,
                        device=v_s.device)
    for row, (cols, sign) in enumerate(_plain_maps(spec, str(v_s.device))):
        table[row].index_add_(0, cols, v_s * sign)
    return table


def sketch_rows(spec, v_s: torch.Tensor) -> torch.Tensor:
    """[d_eff] scrambled vector -> [r, c_actual] f32 table (K1)."""
    _check("sketch_rows v_s", v_s, (spec.d_eff,))
    if v_s.device.type == "cpu":
        return sketch_rows_torch(spec, v_s)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    rows, ptr, off, tile = _kernel_geometry(spec, str(v_s.device))
    table = torch.empty(spec.table_shape, dtype=torch.float32,
                        device=v_s.device)
    _launch(lib.cs_sketch_rows, v_s.data_ptr(), spec.d_eff, ptr.data_ptr(),
            off.data_ptr(), table.data_ptr(), spec.c_actual, rows, spec.r,
            _FAMILY[spec.hash_family], tile, _stream())
    sketch_rows.launches += 1
    return table


sketch_rows.launches = 0


# -- K2: fused estimate + median ----------------------------------------------


def estimate_median_torch(spec, table: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: a gather per row plus the median network."""
    maps = _plain_maps(spec, str(table.device))
    return _median_network(table[row][cols] * sign
                           for row, (cols, sign) in enumerate(maps))


def estimate_median(spec, table: torch.Tensor) -> torch.Tensor:
    """[r, c_actual] table -> [d_eff] median-of-rows estimates in
    scrambled space (K2)."""
    _check("estimate_median table", table, spec.table_shape)
    if table.device.type == "cpu":
        return estimate_median_torch(spec, table)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    rows = _kernel_geometry(spec, str(table.device))[0]
    out = torch.empty(spec.d_eff, dtype=torch.float32, device=table.device)
    _launch(lib.cs_estimate_median, table.data_ptr(), spec.c_actual,
            out.data_ptr(), spec.d_eff, rows, spec.r,
            _FAMILY[spec.hash_family], _stream())
    estimate_median.launches += 1
    return out


estimate_median.launches = 0


# -- K4: point estimates at a coordinate subset -----------------------------------


@functools.lru_cache(maxsize=8)
def _inverse_perm(spec, device: str):
    """The inverse block permutation as int32 on ``device`` (None when the
    spec does not scramble), kept alive here while K4 may read it."""
    inv = spec.inverse_block_perm()
    return None if inv is None else torch.from_numpy(inv).to(device)


def _check_index(name: str, idx: torch.Tensor) -> None:
    if idx.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 indices, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D index tensor, "
                         f"got shape {tuple(idx.shape)}")


def estimate_at_torch(spec, table: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: per row, the signed bucket of each ORIGINAL
    coordinate (scramble, riffle, chunk and slot), then the median
    network."""
    spos = spec.scrambled_pos(idx)
    ests = []
    for row in range(spec.r):
        cols, sign = spec.scrambled_cols_signs(row, spos)
        ests.append(table[row][cols] * sign)
    return _median_network(ests)


def estimate_at(spec, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[r, c_actual] f32 table, [n] int64 original coordinates in [0, d)
    -> [n] f32 median-of-rows estimates (K4). A coordinate out of range
    raises: at once on the CPU, and on the card as a device-side assert
    that surfaces at the next synchronisation."""
    if table.dtype == torch.bfloat16:
        raise TypeError("estimate_at: bf16 tables are not ported; bf16 "
                        "table storage comes with ROADMAP A10")
    _check("estimate_at table", table, spec.table_shape)
    _check_index("estimate_at idx", idx)
    if idx.device != table.device:
        raise ValueError(f"estimate_at: idx on {idx.device}, table on "
                         f"{table.device}")
    if table.device.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= spec.d):
            raise ValueError(f"estimate_at: indices must lie in [0, "
                             f"{spec.d})")
        return estimate_at_torch(spec, table, idx)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    out = torch.empty(idx.numel(), dtype=torch.float32, device=table.device)
    if idx.numel() == 0:
        return out
    lib = load_library()
    rows = _kernel_geometry(spec, str(table.device))[0]
    inv = _inverse_perm(spec, str(table.device))
    err = torch.zeros((), dtype=torch.int32, device=table.device)
    _launch(lib.cs_estimate_at, table.data_ptr(), spec.c_actual,
            idx.data_ptr(), idx.numel(), spec.d,
            None if inv is None else inv.data_ptr(), out.data_ptr(),
            err.data_ptr(), rows, spec.r, _FAMILY[spec.hash_family],
            _stream())
    estimate_at.launches += 1
    torch._assert_async(err == 0, f"estimate_at: an index lies outside "
                                  f"[0, {spec.d})")
    return out


estimate_at.launches = 0


def estimate_at_range_torch(spec, table: torch.Tensor, start: int,
                            n: int) -> torch.Tensor:
    """Plain version of K4's range form: the arbitrary-index plain version
    at the explicit clipped indices."""
    idx = torch.clamp(start + torch.arange(n, device=table.device),
                      max=spec.d - 1)
    return estimate_at_torch(spec, table, idx)


@functools.lru_cache(maxsize=8)
def _range_plan(spec, start: int, n: int, device: str):
    """The range form's host plan for one (spec, slice): the slice's
    scramble blocks in scrambled order and, per CUDA block, the table
    windows it reads (``index_math``), with the rows whose windows go to
    shared memory. Built once per slice (the sharded decode asks for the
    same slice every round) and kept alive here while the kernel may read
    it."""
    b = spec.sblock or 64  # no scramble: walk blocks of 64 in place
    inv = spec.inverse_block_perm()
    blocks = index_math.range_block_list(inv, b, start, n, spec.d)
    per_block = max(1, index_math.K4R_COORDS // b)
    geo = [(spec._factor(r), spec._L_row(r) // spec._factor(r),
            spec.chunk_m, spec.s_row(r), spec.V_row(r))
           for r in range(spec.r)]
    wstart, wlen = index_math.range_windows(blocks, inv, b, start, n,
                                            spec.d, geo, per_block)
    staged = index_math.range_staged_rows(wlen,
                                          index_math.K4R_SMEM_BUDGET)
    woff, wl, used = [0] * spec.r, [0] * spec.r, 0
    for row in staged:
        woff[row], wl[row] = used, int(wlen[row])
        used += int(wlen[row])
    xa, xb = index_math.range_span(start, n, spec.d)
    return dict(
        b=b, blocks=torch.from_numpy(blocks).to(device), per_block=per_block,
        wstart=torch.from_numpy(wstart.astype(np.int32)).to(device),
        woff=(ctypes.c_int * spec.r)(*woff), wlen=(ctypes.c_int * spec.r)(*wl),
        staged=tuple(staged), xa=xa, xb=xb)


def estimate_at_range(spec, table: torch.Tensor, start: int,
                      n: int) -> torch.Tensor:
    """[r, c_actual] f32 table -> [n] f32 median-of-rows estimates at the
    original coordinates ``min(start + arange(n), d - 1)`` (K4's range
    form; no index array is built or read)."""
    _check("estimate_at_range table", table, spec.table_shape)
    if start < 0 or n < 0:
        raise ValueError(f"estimate_at_range: start {start} and n {n} must "
                         f"be >= 0")
    if table.device.type == "cpu":
        return estimate_at_range_torch(spec, table, start, n)
    _check_rows(spec.r)
    out = torch.empty(n, dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    rows = _kernel_geometry(spec, str(table.device))[0]
    inv = _inverse_perm(spec, str(table.device))
    plan = _range_plan(spec, start, n, str(table.device))
    _launch(lib.cs_estimate_range, table.data_ptr(), spec.c_actual, start,
            n, spec.d, plan["xa"], plan["xb"], plan["b"],
            None if inv is None else inv.data_ptr(),
            plan["blocks"].data_ptr(), plan["blocks"].numel(),
            plan["per_block"], plan["wstart"].data_ptr(), plan["woff"],
            plan["wlen"], out.data_ptr(), rows, spec.r,
            _FAMILY[spec.hash_family], _stream())
    estimate_at_range.launches += 1
    return out


estimate_at_range.launches = 0


# -- K3: median over rows ---------------------------------------------------------


def median_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    return _median_network(x[i] for i in range(x.shape[0]))


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 of an [r, n] f32 stack (K3)."""
    if x.dim() != 2:
        raise ValueError(f"median_rows: expected [r, n], got {tuple(x.shape)}")
    _check("median_rows x", x, tuple(x.shape))
    if x.device.type == "cpu":
        return median_rows_torch(x)
    _check_rows(x.shape[0])
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    _launch(lib.cs_median_rows, x.data_ptr(), x.shape[1], x.shape[0],
            out.data_ptr(), _stream())
    median_rows.launches += 1
    return out


median_rows.launches = 0


# -- hash check ---------------------------------------------------------------------


def hash_bits_cuda(spec, row: int, x: torch.Tensor, which: str) -> np.ndarray:
    """Raw 32-bit slot (``which="slot"``) or sign (``"sign"``) hashes of the
    uint32 values in ``x`` (an int64 CUDA tensor), computed by the device
    hash functions of ``csrc/hash.cuh`` — for holding them bit-for-bit
    against the host hashes. Not on the training path."""
    if x.device.type != "cuda":
        raise ValueError("hash_bits_cuda takes a CUDA tensor")
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    params = spec.kernel_row_params()[row]
    prow = (ctypes.c_longlong * params.size)(*params.tolist())
    if x.dtype != torch.int64 or int(x.min()) < 0 or int(x.max()) >= 2**32:
        raise ValueError("hash_bits_cuda takes int64 values in [0, 2^32)")
    # the uint32 bit patterns as int32 (two's complement)
    xs = torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()
    out = torch.empty_like(xs)
    _launch(lib.cs_hash_bits, xs.data_ptr(), out.data_ptr(), xs.numel(),
            prow, 0 if which == "slot" else 1, _FAMILY[spec.hash_family],
            _stream())
    return out.cpu().numpy().view(np.uint32)


KERNELS = (sketch_rows, estimate_median, median_rows, estimate_at,
           estimate_at_range)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
