"""Bytes, counted from shapes.

* What a client sends and receives a round: the ``[r, c]`` float32 table
  up and the dense ``[D]`` update down in ``sketch`` mode; the dense
  ``[D]`` gradient up and update down in ``uncompressed`` mode.
* The least traffic of a CountSketch encode (the ``[D]`` vector read,
  the table written) and of a decode of all D estimates (the table read,
  the ``[D]`` estimates written), each once, in float32. Hashes, scratch
  and permuted copies are the implementation's and are not counted."""

from __future__ import annotations

from benchmark.reference.countsketch import Geometry
from benchmark.yardstick.layout import leaves, num_params

F32 = 4


def table_elems(d: int, opt: dict) -> int:
    """``r x c_actual`` (the realized width does not depend on the hash
    seed)."""
    g = Geometry(d, opt["num_cols"], opt["num_rows"], seed=0)
    return g.r * g.c_actual


def per_client_round(config: dict, tr: dict) -> dict:
    d = num_params(leaves(config))
    opt = tr["optimizer"]
    up = (table_elems(d, opt) if opt["mode"] == "sketch" else d) * F32
    return {"upload_bytes": up, "download_bytes": d * F32}


def countsketch_bytes(d: int, opt: dict) -> dict:
    """``{"encode": bytes, "decode": bytes}`` of one encode of a ``[D]``
    vector and one decode of all D estimates."""
    both = (d + table_elems(d, opt)) * F32
    return {"encode": both, "decode": both}
