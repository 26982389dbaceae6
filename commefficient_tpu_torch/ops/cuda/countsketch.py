"""Wrappers of the CountSketch CUDA kernels, each beside its plain version.

Every wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, and then:

* on a CPU tensor calls its plain PyTorch version (the tests' path);
* on a CUDA tensor launches its kernel on the current stream and raises if
  the launch returned a CUDA error — there is no fallback.

``launches`` on each wrapper counts kernel launches (never plain-version
calls), so a run can show that its main path went through the kernels.
A launch made while the current stream is captured into a CUDA graph (the
scan engine) launches nothing then: it is counted apart
(``capture_counts``), and the graph's replays, which run no Python, are
counted from a profiler's kernel events, never by these counters.

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


TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, t: torch.Tensor, shape: tuple,
           dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes:
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: expected {want}, got {t.dtype}")
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


def _stream(device=None) -> int:
    """The current stream's handle on ``device`` (default: the current
    device), as ``torch.cuda.current_stream(device).cuda_stream`` gives it
    but without building a Stream object: a launch's host time counts
    against the small leaves of K1's segment form."""
    index = device.index if device is not None and device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _check_dtype(name: str, dtype: torch.dtype) -> None:
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {dtype}")


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 (nearest, ties to even) and widen back."""
    return t.to(torch.bfloat16).to(torch.float32)


# {wrapper: {form: n}}: the launches recorded into CUDA graphs
_CAPTURED: dict = {}


def _count(wrapper, form: str) -> None:
    """One launch of ``wrapper``'s kernel in ``form`` (its type variant);
    under a graph capture, one kernel recorded into the graph."""
    if torch._C._cuda_isCurrentStreamCapturing():
        c = _CAPTURED.setdefault(wrapper.__name__, {})
        c[form] = c.get(form, 0) + 1
        return
    wrapper.launches += 1
    wrapper.forms[form] = wrapper.forms.get(form, 0) + 1


# The per-spec plan caches (``_kernel_geometry``, ``_k2_plan``,
# ``_inverse_perm``) are unbounded: a session holds a fixed set of specs
# (one per ladder rung), each entry is a few bytes per coordinate, and an
# eviction would rebuild a plan on the critical path of a rung switch.
# ``plan_builds`` counts their builds.
@functools.lru_cache(maxsize=None)
def _kernel_geometry(spec, device: str):
    """(row params as a ctypes int64 array, CSR ptr, CSR offsets, K1's tile
    width in strides) for the kernels: built once per (spec, device) from
    the same hash functions as the plain versions, and kept alive here
    while the kernels may read them."""
    if max(spec._L_row(r) for r in range(spec.r)) >= 2**32:
        raise ValueError("the CUDA kernels index the padded layout in "
                         "uint32; this spec's layout exceeds 2^32")
    params = spec.kernel_row_params()
    # built once a (spec, device) by the eager warm-up round, before any
    # capture
    # lint: allow[traced-purity] params is a host numpy array, not a tensor
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


def sketch_rows_torch(spec, v_s: torch.Tensor, operand=torch.float32,
                      table_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: an ``index_add_`` scatter per row over the
    precomputed columns and signs of every scrambled position, each signed
    value rounded to ``operand`` first, the sums f32, the table rounded to
    ``table_dtype`` at the end."""
    table = torch.zeros(spec.table_shape, dtype=torch.float32,
                        device=v_s.device)
    for row, (cols, sign) in enumerate(_plain_maps(spec, str(v_s.device))):
        src = v_s * sign
        if operand == torch.bfloat16:
            src = _bf16_round(src)
        table[row].index_add_(0, cols, src)
    return table.to(table_dtype)


def k1_form(operand: torch.dtype, table_dtype: torch.dtype) -> str:
    """The name of K1's type variant: ``f32``, ``bf16_operand``,
    ``bf16_table`` or ``bf16_operand_bf16_table``."""
    parts = [name for name, dt in (("bf16_operand", operand),
                                   ("bf16_table", table_dtype))
             if dt == torch.bfloat16]
    return "_".join(parts) or "f32"


def sketch_rows(spec, v_s: torch.Tensor, operand=torch.float32,
                table_dtype=torch.float32) -> torch.Tensor:
    """[d_eff] f32 scrambled vector -> [r, c_actual] table of
    ``table_dtype`` (K1): each signed value rounded to ``operand`` (f32:
    as it is; bf16: to nearest, ties to even), the sums in f32, the final
    table rounded to ``table_dtype``."""
    _check("sketch_rows v_s", v_s, (spec.d_eff,))
    _check_dtype("operand", operand)
    _check_dtype("table_dtype", table_dtype)
    if v_s.device.type == "cpu":
        return sketch_rows_torch(spec, v_s, operand, table_dtype)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    rows, ptr, off, tile = _kernel_geometry(spec, str(v_s.device))
    form = k1_form(operand, table_dtype)
    if tile == 0 and form != "f32":
        raise ValueError(
            f"sketch_rows: K1's gather kernel (chunk size m = "
            f"{spec.chunk_m} has no tile kernel) takes f32 only, not the "
            f"{form} form")
    table = torch.empty(spec.table_shape, dtype=table_dtype,
                        device=v_s.device)
    _launch(lib.cs_sketch_rows, v_s.data_ptr(), spec.d_eff, ptr.data_ptr(),
            off.data_ptr(), table.data_ptr(), spec.c_actual, rows, spec.r,
            _FAMILY[spec.hash_family], tile,
            int(operand == torch.bfloat16),
            int(table_dtype == torch.bfloat16), _stream())
    _count(sketch_rows, form)
    return table


sketch_rows.launches = 0
sketch_rows.forms = {}


# -- K1's segment form: one leaf's values into an existing table -------------


def sketch_segment_torch(spec, offset: int, vals: torch.Tensor,
                         table: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's segment form: per row, one ``index_add_`` of
    the signed values at the columns of the original coordinates
    ``[offset, offset + n)``, into ``table`` in place."""
    spos = spec.scrambled_pos(offset + torch.arange(vals.numel(),
                                                    device=vals.device))
    for row in range(spec.r):
        cols, sign = spec.scrambled_cols_signs(row, spos)
        table[row].index_add_(0, cols, vals * sign)
    return table


@functools.lru_cache(maxsize=8)
def _segment_scratch(spec, device: str) -> dict:
    """K1's segment form's fixed scratch on ``device``, allocated once per
    (spec, device) and reused leaf after leaf: ``capacity`` piece-rows of
    ``index_math.SEG_PIECE`` values (``bytes`` at most
    ``index_math.SEG_SCRATCH_BUDGET``), with the tile shift of each row
    group size (``shifts``), and the launch's fixed arguments."""
    shifts = index_math.segment_shifts(spec.r, spec.c_actual)
    ntiles = -(-spec.c_actual >> shifts[0])  # one row alone: the most tiles
    capacity = index_math.segment_capacity(spec.r, spec.d, ntiles)
    nbytes = index_math.segment_scratch_bytes(capacity, ntiles)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    inv = _inverse_perm(spec, device)
    rows = _kernel_geometry(spec, device)[0]
    shifts_c = (ctypes.c_int * spec.r)(*shifts)
    # cs_sketch_segment's arguments between (vals, offset, n) and table, and
    # after the table up to the stream
    args = ((None if inv is None else inv.data_ptr(), buf.data_ptr(),
             capacity, ntiles, shifts_c),
            (spec.c_actual, rows, spec.r, _FAMILY[spec.hash_family]))
    return dict(shifts=shifts, capacity=capacity, bytes=nbytes, buf=buf,
                args=args)


def prepare_segments(spec, segments, device) -> None:
    """Allocate K1's segment form's scratch and build its kernel geometry
    and inverse block permutation on a CUDA ``device`` ahead of the first
    launch, so no backward pass allocates them between its own
    allocations; nothing on the CPU. The scratch is sized by the spec, so
    ``segments`` (``(offset, n)`` pairs) are only checked to lie in
    ``[0, d)``."""
    for offset, n in segments:
        if offset < 0 or n < 0 or offset + n > spec.d:
            raise ValueError(f"prepare_segments: [{offset}, {offset + n}) "
                             f"is not inside [0, {spec.d})")
    device = torch.device(device)
    if device.type != "cuda":
        return
    _segment_scratch(spec, str(device))


def sketch_segment(spec, offset: int, vals: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """Add the ``n`` f32 ``vals`` of original coordinates ``[offset,
    offset + n)`` into the f32 ``[r, c_actual]`` ``table``, in place, and
    return it (K1's segment form: no ``[d]`` buffer, no float atomics, so
    two launches on the same inputs give bit-identical tables). On the
    card each column's contributions are summed left to right in the
    leaf's order, a scratch window (``_segment_scratch``) at a time, and
    added into the table once a window; a leaf of at most
    ``index_math.SEG_PIECE`` values is one launch with no scratch."""
    n = vals.numel()
    _check("sketch_segment vals", vals, (n,))
    _check("sketch_segment table", table, spec.table_shape)
    if vals.device != table.device:
        raise ValueError(f"sketch_segment: vals on {vals.device}, table on "
                         f"{table.device}")
    if offset < 0 or offset + n > spec.d:
        raise ValueError(f"sketch_segment: [{offset}, {offset + n}) is not "
                         f"inside [0, {spec.d})")
    if n == 0:
        return table
    if vals.device.type == "cpu":
        return sketch_segment_torch(spec, offset, vals, table)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    if table.data_ptr() % 16:
        raise ValueError("sketch_segment: the kernel reads the table as "
                         "float4; it must be 16-byte aligned")
    lib = load_library()
    head, tail = _segment_scratch(spec, str(vals.device))["args"]
    _launch(lib.cs_sketch_segment, vals.data_ptr(), offset, n, *head,
            table.data_ptr(), *tail, _stream(vals.device))
    _count(sketch_segment, "f32")
    return table


sketch_segment.launches = 0
sketch_segment.forms = {}


# -- K2: every coordinate's estimate, in original order -------------------------


def _read_table(table: torch.Tensor, operand) -> torch.Tensor:
    """The table as K2 reads it: widened to f32, each entry rounded to
    ``operand`` (a no-op for a bf16 table or an f32 operand)."""
    t = table.to(torch.float32)
    if operand == torch.bfloat16 and table.dtype == torch.float32:
        t = _bf16_round(t)
    return t


def estimate_median_torch(spec, table: torch.Tensor,
                          operand=torch.float32) -> torch.Tensor:
    """Plain version of K2: a gather per row of the table read as
    ``operand`` plus the median network, in scrambled space, then the
    unscramble."""
    from commefficient_tpu_torch.ops.countsketch import _unscramble

    t = _read_table(table, operand)
    maps = _plain_maps(spec, str(table.device))
    return _unscramble(spec, _median_network(
        t[row][cols] * sign for row, (cols, sign) in enumerate(maps)))


def k2_form(table_dtype: torch.dtype, operand: torch.dtype) -> str:
    """The name of K2's type variant: ``f32``, ``f32_table_bf16_operand``
    (each f32 entry rounded to bf16 at the read) or ``bf16_table`` (each
    entry widened at the read; the operand type changes nothing)."""
    if table_dtype == torch.bfloat16:
        return "bf16_table"
    return "f32_table_bf16_operand" if operand == torch.bfloat16 else "f32"


K2_TABLE_KIND = {"f32": 0, "f32_table_bf16_operand": 1, "bf16_table": 2}


SIGN_WORDS_PER_STEP = 1 << 20  # words packed per step (bounds the temporaries)


def packed_sign_bits(spec, device) -> torch.Tensor:
    """[r, ceil(d_eff / 32)] int32: bit t of word w of a row is the sign bit
    (1 = negative) of scrambled position 32 w + t (``spec.sign_bits``); the
    bits past d_eff are 0. Built on ``device`` in plain torch."""
    nw = -(-spec.d_eff // 32)
    out = torch.empty(spec.r, nw, dtype=torch.int32, device=device)
    weight = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, device=device)
    for row in range(spec.r):
        for w0 in range(0, nw, SIGN_WORDS_PER_STEP):
            w1 = min(nw, w0 + SIGN_WORDS_PER_STEP)
            pos = torch.arange(32 * w0, 32 * w1, device=device)
            bits = spec.sign_bits(row, pos) * (pos < spec.d_eff)
            words = (bits.view(-1, 32) * weight).sum(1)  # < 2^32
            out[row, w0:w1] = torch.where(words >= 2**31, words - 2**32,
                                          words).to(torch.int32)
    return out


def _row_geo(spec) -> list:
    """``[(f, G, m, s, V), ...]`` per row, for ``index_math``'s windows."""
    return [(spec._factor(r), spec._L_row(r) // spec._factor(r),
             spec.chunk_m, spec.s_row(r), spec.V_row(r))
            for r in range(spec.r)]


@functools.lru_cache(maxsize=None)
def _k2_plan(spec, device: str, itemsize: int = 4):
    """K2's host plan, built once per spec and kept alive here while the
    kernel may read it: tiles of ``index_math.K2_COORDS`` scrambled
    positions (whole scramble blocks) with their table windows (K4's range
    plan at every coordinate) and staged rows, the forward block
    permutation, the slot tables [r, m] and the packed sign bits. The
    windows are staged in the table's type (``itemsize`` bytes an
    entry), and the budget counts their bytes."""
    b = spec.sblock or 64  # no scramble: tiles of blocks of 64 in place
    inv = spec.inverse_block_perm()
    # every block, sorted by scrambled position: the forward permutation
    blocks = index_math.range_block_list(inv, b, 0, spec.d, spec.d)
    per_block = max(1, index_math.K2_COORDS // b)
    wstart, wlen = index_math.range_windows(blocks, inv, b, 0, spec.d,
                                            spec.d, _row_geo(spec), per_block)
    staged = index_math.k2_staged_rows(wlen, index_math.K2_WINDOW_BUDGET,
                                       itemsize)
    woff, wl = [0] * spec.r, [0] * spec.r
    for row in staged:
        woff[row], wl[row] = sum(wl[:row]), int(wlen[row])
    m = spec.chunk_m
    slots = torch.stack([spec.slot_hash(row, torch.arange(m))
                         for row in range(spec.r)]).to(torch.int32)
    slot_smem = index_math.k2_slots_in_smem(
        spec.r, m, max(spec.V_row(r) for r in range(spec.r)))
    return dict(
        b=b, per_tile=per_block * b, ntiles=int(wstart.shape[0]),
        perm=torch.from_numpy(blocks).to(device) if spec.sblock else None,
        wstart=torch.from_numpy(wstart.astype(np.int32)).to(device),
        wlen_all=wlen, staged=staged, woff=(ctypes.c_int * spec.r)(*woff),
        wlen=(ctypes.c_int * spec.r)(*wl), slots=slots.to(device),
        slot_smem=slot_smem, signs=packed_sign_bits(spec, device),
        smem_bytes=index_math.k2_smem_bytes(spec.r, m, slot_smem, per_block,
                                            sum(wl), itemsize))


def estimate_median(spec, table: torch.Tensor,
                    operand=torch.float32) -> torch.Tensor:
    """[r, c_actual] f32 or bf16 table -> [d] f32 median-of-rows estimates
    in ORIGINAL coordinate order (K2: the estimate, the median and the
    unscramble in one launch), each entry read as ``operand``: a bf16
    table widens; an f32 table rounds to bf16 when ``operand`` is bf16."""
    _check("estimate_median table", table, spec.table_shape, TABLE_DTYPES)
    _check_dtype("operand", operand)
    if table.device.type == "cpu":
        return estimate_median_torch(spec, table, operand)
    _check_rows(spec.r)
    from commefficient_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    dev = str(table.device)
    rows = _kernel_geometry(spec, dev)[0]
    plan = _k2_plan(spec, dev, table.element_size())
    form = k2_form(table.dtype, operand)
    out = torch.empty(spec.d, dtype=torch.float32, device=table.device)
    _launch(lib.cs_estimate_median, table.data_ptr(), spec.c_actual,
            out.data_ptr(), spec.d, spec.d_eff,
            None if plan["perm"] is None else plan["perm"].data_ptr(),
            plan["b"], plan["per_tile"], plan["ntiles"],
            plan["slots"].data_ptr(), spec.chunk_m, int(plan["slot_smem"]),
            plan["signs"].data_ptr(), plan["signs"].shape[1],
            plan["wstart"].data_ptr(), len(plan["staged"]), plan["woff"],
            plan["wlen"], rows, spec.r, K2_TABLE_KIND[form], _stream())
    _count(estimate_median, form)
    return out


estimate_median.launches = 0
estimate_median.forms = {}


def estimate_all_slices(spec):
    """The ``(start, n)`` coordinate slices ``estimate_all`` walks at
    ``num_blocks > 1`` (K4's range form a slice); () at one block."""
    if spec.num_blocks == 1:
        return ()
    blk = -(-spec.d // spec.num_blocks)
    return tuple((start, blk) for start in range(0, spec.d, blk))


def prepare_plans(spec, device, slices=()) -> None:
    """Build, without a launch, the host plans of ``spec`` on ``device``
    that K1, K2 and K4 read (the per-spec caches their first launch would
    fill): K1's row geometry, the inverse block permutation, for the
    one-kernel decode (``num_blocks == 1``) K2's plan, and K4's range
    plan of every slice ``estimate_all`` walks at ``num_blocks > 1`` and
    of each ``(start, n)`` of ``slices`` (the sharded decode's slice of
    this rank); each for an f32 table and, with bf16 storage, for a bf16
    one. The control plane builds them for every ladder rung before the
    first round; the caches keep every entry, so a rung switch builds
    none (``plan_builds``)."""
    dev = str(device)
    _kernel_geometry(spec, dev)
    _inverse_perm(spec, dev)
    sizes = (4, 2) if spec.table_dtype == torch.bfloat16 else (4,)
    for itemsize in sizes:
        if spec.num_blocks == 1:
            _k2_plan(spec, dev, itemsize)
        for start, n in (*estimate_all_slices(spec), *slices):
            # positional, as estimate_at_range asks: the cache keys on
            # the argument form
            _range_plan(spec, int(start), int(n), dev, itemsize)


def plan_builds() -> int:
    """Host plans built so far in this process: the misses of the
    per-spec caches K1, K2 and K4 read (``prepare_plans`` fills them)."""
    return sum(f.cache_info().misses for f in (
        _kernel_geometry, _k2_plan, _inverse_perm, _range_plan))


# -- K4: point estimates at a coordinate subset -----------------------------------


@functools.lru_cache(maxsize=None)
def _inverse_perm(spec, device: str):
    """The inverse block permutation as int32 on ``device`` (None when the
    spec does not scramble), kept alive here while K4 or K1's segment form
    may read it."""
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
    coordinate (scramble, riffle, chunk and slot), widened to f32, then
    the median network."""
    spos = spec.scrambled_pos(idx)
    ests = []
    for row in range(spec.r):
        cols, sign = spec.scrambled_cols_signs(row, spos)
        ests.append(table[row][cols].to(torch.float32) * sign)
    return _median_network(ests)


def k4_form(table_dtype: torch.dtype) -> str:
    return "bf16_table" if table_dtype == torch.bfloat16 else "f32"


def estimate_at(spec, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[r, c_actual] f32 or bf16 table, [n] int64 original coordinates in
    [0, d) -> [n] f32 median-of-rows estimates (K4; a bf16 entry is
    widened at the read, never rounded further). A coordinate out of
    range raises: at once on the CPU, and on the card as a device-side
    assert that surfaces at the next synchronisation."""
    _check("estimate_at table", table, spec.table_shape, TABLE_DTYPES)
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
            int(table.dtype == torch.bfloat16), _stream())
    _count(estimate_at, k4_form(table.dtype))
    torch._assert_async(err == 0, f"estimate_at: an index lies outside "
                                  f"[0, {spec.d})")
    return out


estimate_at.launches = 0
estimate_at.forms = {}


def estimate_at_range_torch(spec, table: torch.Tensor, start: int,
                            n: int) -> torch.Tensor:
    """Plain version of K4's range form: the arbitrary-index plain version
    at the explicit clipped indices."""
    idx = torch.clamp(start + torch.arange(n, device=table.device),
                      max=spec.d - 1)
    return estimate_at_torch(spec, table, idx)


@functools.lru_cache(maxsize=None)
def _range_plan(spec, start: int, n: int, device: str, itemsize: int = 4):
    """The range form's host plan for one (spec, slice): the slice's
    scramble blocks in scrambled order and, per CUDA block, the table
    windows it reads (``index_math``), with the rows whose windows go to
    shared memory. Built once per slice (the sharded decode asks for the
    same slice every round) and kept alive here while the kernel may read
    it. Windows are staged in the table's type (``itemsize`` bytes). The
    cache keeps every plan (a session's specs and slices are fixed): the
    sharded decode's slice and every slice of ``estimate_all`` at
    ``num_blocks > 1``, of each ladder rung (``prepare_plans``)."""
    b = spec.sblock or 64  # no scramble: walk blocks of 64 in place
    inv = spec.inverse_block_perm()
    blocks = index_math.range_block_list(inv, b, start, n, spec.d)
    per_block = max(1, index_math.K4R_COORDS // b)
    wstart, wlen = index_math.range_windows(blocks, inv, b, start, n,
                                            spec.d, _row_geo(spec), per_block)
    staged = index_math.range_staged_rows(wlen, index_math.K4R_SMEM_BUDGET,
                                          itemsize)
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
    """[r, c_actual] f32 or bf16 table -> [n] f32 median-of-rows
    estimates at the original coordinates ``min(start + arange(n), d -
    1)`` (K4's range form; no index array is built or read; a bf16 entry
    is widened at the read)."""
    _check("estimate_at_range table", table, spec.table_shape, TABLE_DTYPES)
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
    plan = _range_plan(spec, start, n, str(table.device),
                       table.element_size())
    _launch(lib.cs_estimate_range, table.data_ptr(), spec.c_actual, start,
            n, spec.d, plan["xa"], plan["xb"], plan["b"],
            None if inv is None else inv.data_ptr(),
            plan["blocks"].data_ptr(), plan["blocks"].numel(),
            plan["per_block"], plan["wstart"].data_ptr(), plan["woff"],
            plan["wlen"], out.data_ptr(), rows, spec.r,
            _FAMILY[spec.hash_family], int(table.dtype == torch.bfloat16),
            _stream())
    _count(estimate_at_range, k4_form(table.dtype))
    return out


estimate_at_range.launches = 0
estimate_at_range.forms = {}


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
    _count(median_rows, "f32")
    return out


median_rows.launches = 0
median_rows.forms = {}


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


KERNELS = (sketch_rows, sketch_segment, estimate_median, median_rows,
           estimate_at, estimate_at_range)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.forms = {}
    _CAPTURED.clear()


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def launches_since(before: dict, counts=None) -> dict:
    """``{wrapper: {form: n}}`` counted since ``before`` (``form_counts()``
    taken earlier; with ``counts=capture_counts`` the kernels captured
    since a ``capture_counts()``), nonzero entries only."""
    now = (counts or form_counts)()
    out = {}
    for name, forms in now.items():
        was = before.get(name, {})
        d = {f: n - was.get(f, 0) for f, n in forms.items()
             if n != was.get(f, 0)}
        if d:
            out[name] = d
    return out


def capture_counts() -> dict:
    """``{wrapper: {form: n}}`` of the kernels recorded into CUDA graphs
    since the last reset (each runs once a replay of its graph)."""
    return {name: dict(forms) for name, forms in _CAPTURED.items()}


def form_counts() -> dict:
    """``{wrapper: {form: launches}}`` since the last reset: the type
    variants (``k1_form``, ``k2_form``, ``k4_form``) each kernel ran
    in."""
    return {k.__name__: dict(k.forms) for k in KERNELS}
