"""The comparison that decides ``correct``, on the CPU at small sizes:

* in float32 the program and the reference agree to rounding (the
  reference works out the same batches, hashes and updates);
* the program at the configuration's precision passes the cells' small
  limits, and its fp8 control does not;
* a run whose timed path is broken underneath, with the chip's look
  skipped, comes out not correct: a step that returns its state
  unchanged, and half of every client's batch left out (the mean over
  the rest). One chip: no exchange between chips to leave out, and no
  served token to alter."""

from dataclasses import replace

import pytest

from benchmark import calibrate
from benchmark.harness import bench, check
from benchmark.tests.cells import SEED, WORKLOADS, tiny

# tiny sketch tables sit outside the program's stable envelope
pytestmark = pytest.mark.filterwarnings("ignore:sketch mode at realized")


def _run(cell, tamper=None):
    return bench.run(cell, SEED, 0.2, False, "cpu", 0.0, tamper=tamper)


# in float32 the losses and the momentum agree to rounding; the change can
# differ by the few coordinates at the top-k threshold whose order the
# float32 sums' order flips (one such coordinate on a leaf reads ~0.01)
FLOAT32_GAPS = {"loss_gap": 1e-5, "state_gap": 1e-5, "delta_gap": 0.02}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float32_program_agrees_with_reference(workload):
    cell = tiny(workload)
    cell.config["compute_dtype"] = "float32"
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] < FLOAT32_GAPS[name], (name, c)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes(workload):
    res = _run(tiny(workload))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_fp8_control_fails(workload):
    cell = tiny(workload)
    r = calibrate.readings(cell, SEED, "control", "cpu")
    assert not check.verdict(r, cell.traffic["limits"])


def _unchanged(session):
    inner = session.round_fn

    def round_fn(state, *args, **kw):
        _, metrics = inner(state, *args, **kw)
        return replace(state, step=state.step + 1), metrics

    session.round_fn = round_fn


def _half_batch(session):
    inner = session.round_fn

    def round_fn(state, ids, batch, *args, **kw):
        half = {k: v[:, : v.shape[1] // 2] for k, v in batch.items()}
        return inner(state, ids, half, *args, **kw)

    session.round_fn = round_fn


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault):
    res = _run(tiny(workload), tamper=fault)
    assert not res["correct"], res["checks"]


def test_look_counts_top_k_and_common_change():
    """The look at ``delta_gap``: each round both sides of a sketch cell
    move exactly k coordinates, and over the coordinates both moved the
    change's gap is no larger than over the program's whole change."""
    cell = tiny("resnet9.sketch_scan4")
    out = calibrate.look(cell, SEED, "cpu")
    k = cell.traffic["optimizer"]["k"]
    assert len(out["rounds"]) == cell.traffic["check"]["rounds"]
    for r in out["rounds"]:
        assert r["moved_program"] == r["moved_reference"] == k
        assert r["only_program"] == r["only_reference"]
    assert out["common"]["delta_gap"] <= out["full"]["delta_gap"]
