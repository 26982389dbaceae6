"""The port's FSDP round (``parallel/fsdp.py``) against the reference, on
the CPU.

* four-round TinyMLP sessions of uncompressed (with server momentum),
  true_topk and sketch (virtual error, momentum) under ``fsdp=True`` with
  the threshold top-k, against the reference's FSDP session: at one device
  (one process) and at two (two gloo ranks against the reference's
  2-device mesh, in the spawn tests/test_torch_sparse_aggregate.py starts
  for the same job), losses ``rtol 1e-4``, params ``atol 1e-5``, server
  leaves ``atol 1e-5 * max|leaf|`` in the full padded layout; at one
  device also against the port's replicated round (``atol 2e-5``, the
  reference's own FSDP-vs-replicated bound);
* on two ranks each rank holds ``padded_dim(D, 2) / 2`` of the params and
  of each dense server leaf, and the sketch tables whole;
  ``per_chip_state_floats`` equals the reference's accounting;
* the refusals (client-state modes, a top-k other than threshold, sketch
  dampening), the eval and ``params`` on the whole vector, and a resumed
  FSDP run bit-equal to the straight one (one device here; two ranks in
  tests/test_torch_sparse_aggregate.py).
"""

import numpy as np
import pytest
import torch

from commefficient_tpu.parallel.fsdp import (
    per_chip_state_floats as ref_per_chip_state_floats,
)
from commefficient_tpu_torch.compress import get_compressor
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.fsdp import per_chip_state_floats
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.config import Config
from test_round import BASE
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_sharded_decode import (  # noqa: F401  (the fixture)
    LR,
    _assert_twin,
    _port_run,
    rounds,
)
from test_torch_sparse_aggregate import (  # noqa: F401  (the fixture)
    TWO_RANK_CASES,
    ranks_case,
    ref_run,
    two_ranks,
)

FSDP_CASES = sorted(n for n in TWO_RANK_CASES if n.startswith("fsdp"))


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_one_device_matches_reference_and_replicated(rounds, name):
    kw = {**BASE, "num_devices": 1, **TWO_RANK_CASES[name]}
    want = ref_run(rounds, kw)
    got = _port_run(rounds, kw)
    _assert_twin(got, want)
    rep = _port_run(rounds, {**kw, "fsdp": False})
    np.testing.assert_allclose(got["params"], rep["params"], rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_two_gloo_ranks_match_reference(rounds, two_ranks, name):
    kw = {**BASE, "num_devices": 2, **TWO_RANK_CASES[name]}
    want = ref_run(rounds, kw)
    got = ranks_case(two_ranks, name)
    assert str(got["aggregate"]) == want["aggregate"] == "dense"
    assert bool(got["interop_roundtrip"])  # full layout -> numpy -> slices
    _assert_twin(got, want)
    # what each rank holds: half the padded params and dense leaves, the
    # sketch tables whole
    half = -(-got["params"].size // 2)
    if name == "fsdp_sketch":
        want_numel = [half, got["momentum"].size, got["error"].size]
    else:  # uncompressed keeps no error bank
        want_numel = [half, half, half if "true_topk" in name else 0]
    np.testing.assert_array_equal(got["rank_numel"], want_numel)


def _comp(cfg, d=212):
    spec = (CountSketch(d=d, c=cfg.num_cols, r=cfg.num_rows)
            if cfg.mode == "sketch" else None)
    return get_compressor(cfg, d=d, spec=spec)


@pytest.mark.parametrize("name", FSDP_CASES)
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_per_chip_state_floats_match_reference(name, shards):
    from commefficient_tpu.ops.countsketch import CountSketch as RefSketch
    from commefficient_tpu.utils.config import Config as RefConfig

    kw = {**BASE, **TWO_RANK_CASES[name]}
    cfg = Config(**kw)
    ref_spec = (RefSketch(d=212, c=cfg.num_cols, r=cfg.num_rows)
                if cfg.mode == "sketch" else None)
    want = ref_per_chip_state_floats(RefConfig(**kw), 212, ref_spec, shards)
    assert per_chip_state_floats(cfg, _comp(cfg), 212, shards) == want


@pytest.mark.parametrize("kw,error,match", [
    (dict(mode="local_topk", error_type="local", k=64,
          topk_method="threshold"), NotImplementedError,
     "offload_client_state"),
    (dict(mode="true_topk", error_type="virtual", k=64,
          topk_method="exact"), NotImplementedError, "threshold"),
    (dict(mode="sketch", error_type="virtual", virtual_momentum=0.9, k=32,
          num_rows=3, num_cols=80, topk_method="threshold",
          momentum_dampening=True, allow_unstable_sketch_dampening=True),
     NotImplementedError, "dampening"),
])
def test_fsdp_refuses_what_the_reference_refuses(rounds, kw, error, match):
    from commefficient_tpu.parallel import FederatedSession as RefSession
    from commefficient_tpu.utils.config import Config as RefConfig

    _, params, loss_ref, _ = rounds
    full = {**BASE, "num_devices": 1, **kw, "fsdp": True}
    with pytest.raises(error, match=match):
        FederatedSession(Config(**full, device="cpu"), to_numpy_tree(params),
                         classification_loss(torch_tinymlp))
    with pytest.raises(error, match=match):
        RefSession(RefConfig(**full), params, loss_ref)


def _fsdp_session(params, **over):
    kw = {**BASE, "num_devices": 1, **TWO_RANK_CASES["fsdp_true_topk"],
          **over}
    return FederatedSession(Config(**kw, device="cpu"), to_numpy_tree(params),
                            classification_loss(torch_tinymlp))


def test_fsdp_eval_params_and_resume(rounds, tmp_path):
    ds, params, _, batches = rounds
    sess = _fsdp_session(params)
    assert sess.sharded_leaves == ("params_vec", "momentum", "error")
    assert torch.equal(ravel_params(sess.params)[0], sess.full_params_vec())
    out = sess.evaluate([{"x": ds.data["x"][:64], "y": ds.data["y"][:64],
                          "_valid": np.asarray(64)}])
    assert np.isfinite(out["loss"])
    straight = _fsdp_session(params)
    for ids, b in batches:
        straight.train_round(ids, b, LR)
    first = _fsdp_session(params, checkpoint_dir=str(tmp_path))
    for ids, b in batches[:2]:
        first.train_round(ids, b, LR)
    FedCheckpointer(first.cfg).maybe_save(first, 2, force=True)
    second = _fsdp_session(params, checkpoint_dir=str(tmp_path))
    assert FedCheckpointer(second.cfg).restore(second) == 2
    for ids, b in batches[2:]:
        second.train_round(ids, b, LR)
    for leaf in ("params_vec", "momentum", "error"):
        assert torch.equal(getattr(second.state, leaf),
                           getattr(straight.state, leaf)), leaf
