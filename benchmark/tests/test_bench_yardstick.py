"""The frozen yardsticks against hand counts at small shapes, and the
layout and sketch geometry against the program's own (which the
benchmark does not import outside its tests)."""

import math

import pytest
import torch

from benchmark.reference.countsketch import Geometry, estimate, sketch
from benchmark.tests.cells import tiny
from benchmark.yardstick import bytes_moved, flops, layout
from commefficient_tpu_torch.models.gpt2 import GPT2Config, gpt2_shapes
from commefficient_tpu_torch.models.resnet9 import resnet9_shapes
from commefficient_tpu_torch.ops.countsketch import (
    CountSketch,
    estimate_all,
    sketch_vec,
)


def test_full_size_parameter_counts():
    g = tiny("gpt2.sketch").config
    g.update(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
             n_head=12)
    r = tiny("resnet9.sketch_scan4").config
    r.update(width=64)
    assert layout.num_params(layout.leaves(g)) == 124_444_417
    assert layout.num_params(layout.leaves(r)) == 6_573_130


@pytest.mark.parametrize("workload", ["gpt2.sketch", "resnet9.sketch_scan4"])
def test_layout_is_the_programs_ravel_order(workload):
    cfg = tiny(workload).config
    if cfg["family"] == "gpt2":
        port = gpt2_shapes(GPT2Config(
            vocab_size=cfg["vocab_size"] + cfg["added_special_tokens"],
            n_positions=cfg["n_positions"], n_embd=cfg["n_embd"],
            n_layer=cfg["n_layer"], n_head=cfg["n_head"]))
    else:
        port = resnet9_shapes(cfg["num_classes"], cfg["width"],
                              cfg["in_channels"])
    ours = layout.leaves(cfg)
    theirs = [(p, tuple(s)) for p, s in _leaves_of_shapes(port)]
    assert ours == theirs


def _leaves_of_shapes(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _leaves_of_shapes(tree[k], path)
        else:
            yield path, tree[k]


def test_gpt2_flops_by_hand():
    cfg = {"n_embd": 4, "n_layer": 2, "n_inner": None, "vocab_size": 10,
           "added_special_tokens": 0}
    T = 3
    # a block: qkv 4x12, proj 4x4, fc 4x16, proj 16x4 = 192 weights a
    # token, attention 2 * T * E = 24; head 4 x 10 = 40
    fwd = 2 * (2 * (192 + 24) + 40)
    assert flops.gpt2_per_token(cfg, T) == 3 * fwd
    tr = {"round": {"num_workers": 2, "local_batch_size": 3},
          "data": {"max_seq_len": T, "num_candidates": 2}}
    assert flops.per_round({"family": "gpt2", **cfg}, tr) == \
        2 * 3 * 2 * T * 3 * fwd


def test_resnet9_flops_by_hand():
    cfg = {"family": "resnet9", "width": 1, "in_channels": 3,
           "num_classes": 2, "image_size": 8}
    # convs (cin, cout, hw): 3-1 @8 (no input gradient), 1-2 @8, then
    # 2-2 twice @4, 2-4 @4, 4-8 @2, 8-8 twice @1; dense 8x2
    convs = [(1, 2, 8), (2, 2, 4), (2, 2, 4), (2, 4, 4), (4, 8, 2),
             (8, 8, 1), (8, 8, 1)]
    want = 2 * (2 * 9 * 3 * 1 * 64) + sum(
        3 * 2 * 9 * a * b * hw * hw for a, b, hw in convs) + 3 * 2 * 8 * 2
    assert flops.resnet9_per_image(cfg) == want


def test_countsketch_bytes_by_hand():
    opt = {"num_cols": 1000, "num_rows": 3}
    g = Geometry(5000, 1000, 3, 7)
    got = bytes_moved.countsketch_bytes(5000, opt)
    assert got == {"encode": 4 * (5000 + 3 * g.c_actual),
                   "decode": 4 * (5000 + 3 * g.c_actual)}
    cfg = tiny("gpt2.sketch").config
    d = layout.num_params(layout.leaves(cfg))
    tr = tiny("gpt2.uncompressed").traffic
    assert bytes_moved.per_client_round(cfg, tr) == {
        "upload_bytes": 4 * d, "download_bytes": 4 * d}


@pytest.mark.parametrize("d,c,seed", [(1000, 300, 1),
                                      (100_003, 5000, 2**31 + 5),
                                      (6_573_130, 500_000, 42)])
def test_geometry_is_the_programs(d, c, seed):
    spec = CountSketch(d=d, c=c, r=5, seed=seed)
    g = Geometry(d, c, 5, seed)
    assert g.c_actual == spec.c_actual and g.m == spec.chunk_m
    assert g.factors == [spec._factor(i) for i in range(5)]


def test_reference_sketch_and_estimate_match_the_program():
    d, c, seed = 50_000, 2000, 2**31 + 11
    spec = CountSketch(d=d, c=c, r=5, seed=seed)
    g = Geometry(d, c, 5, seed)
    v = torch.randn(d, generator=torch.Generator().manual_seed(0))
    t = sketch_vec(spec, v)
    ours = sketch(g, v)
    assert torch.allclose(t, ours, atol=1e-5 * float(t.abs().max()))
    assert torch.equal(estimate(g, t), estimate_all(spec, t))
    assert math.isclose(float(torch.linalg.vector_norm(ours)),
                        float(torch.linalg.vector_norm(t)), rel_tol=1e-6)
