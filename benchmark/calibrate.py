"""The readings a cell's correctness limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --program-seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--look-seeds 10] \\
        [--out FILE]

For each program seed: the program is built and driven through its set-up
exactly as a run's (``harness/bench.py``'s ``setup``: the runner's round
source, the same first rounds), and its readings are compared with the
reference's (``harness/check.py``). For each control seed: the reference
computed with fp8 operands in every product (the precision below the
configuration's bf16) in the program's place. For each fault seed: the
reference with half of every client's batch left out (the mean over the
rest) in the program's place. For each look seed, where the change's gap
comes from (``look``). One JSON line a reading; the runs of the
benchmark never call this. Needs a CUDA device for the cell's sizes (the
tests call ``readings`` on the CPU at small ones)."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, kind: str, device: str) -> dict:
    """One reading: ``kind`` is ``program``, ``control`` or
    ``half_batch``."""
    import torch

    from benchmark.harness import bench, check, program
    from benchmark.yardstick import traffic

    tr = cell.traffic
    t0 = time.perf_counter()
    if kind == "program":
        prog = program.build(cell.config, tr, seed, device)
        rounds, _, cand = bench.setup(prog, tr)
        rounds.close()
        data, ci = prog.data, prog.client_indices
        del prog, rounds
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    else:
        data, ci = traffic.make(cell.config, tr["data"], seed, device)
    t1 = time.perf_counter()
    ref = check.follow(cell.config, tr, seed, data, ci, device)
    t2 = time.perf_counter()
    if kind == "control":
        cand = check.follow(cell.config, tr, seed, data, ci, device,
                            rounding="fp8")
    elif kind == "half_batch":
        cand = check.follow(cell.config, tr, seed, data, ci, device,
                            fault="half_batch")
    detail = {}
    values = check.numbers(cell.config, tr, seed, cand, ref, detail)
    return {"kind": kind, "seed": seed, **values,
            "program_s": t1 - t0, "reference_s": t2 - t1,
            "worst_leaves": _worst_leaves(detail)}


def look(cell, seed: int, device: str) -> dict:
    """Where ``delta_gap`` comes from. The program runs the checked rounds
    one round source a round, so that its parameters can be read after
    each; the reference follows them. For each round: the coordinates
    each side moves (a sketch cell moves the top-k), those only one side
    moves and their share of that side's change, and over the
    coordinates both move the relative norm of the difference and the gap
    of the norms. Then the check's numbers again over the program's own
    change (``full``), and over only the coordinates both sides moved in
    each round (``common``), with the worst leaves of each and how many
    of their coordinates each side moved."""
    import torch

    from benchmark.harness import check, program
    from benchmark.yardstick import weights
    from benchmark.yardstick.layout import leaves, offsets

    tr = cell.traffic
    prog = program.build(cell.config, tr, seed, device)
    prog_w = []
    for r in range(tr["check"]["rounds"]):
        src = prog.rounds(r, r + 1)
        next(src)
        src.close()
        prog_w.append(prog.session.state.params_vec.detach().to(
            "cpu", copy=True))
    data, ci = prog.data, prog.client_indices
    del prog, src
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref_w = []
    ref = check.follow(cell.config, tr, seed, data, ci, device,
                       after_round=lambda r, w: ref_w.append(
                           w.detach().to("cpu", copy=True)))
    w0 = weights.initial_params(cell.config, seed, device).cpu()
    norm = torch.linalg.vector_norm
    rows, acc_p, acc_r = [], torch.zeros_like(w0), torch.zeros_like(w0)
    sel_p = torch.zeros_like(w0, dtype=torch.bool)
    sel_r = torch.zeros_like(sel_p)
    prev_p = prev_r = w0
    for r, (wp, wr) in enumerate(zip(prog_w, ref_w)):
        dp, dr = wp - prev_p, wr - prev_r
        p, q = dp != 0, dr != 0
        c = p & q
        rows.append({
            "round": r, "moved_program": int(p.sum()),
            "moved_reference": int(q.sum()),
            "only_program": int((p & ~q).sum()),
            "only_reference": int((q & ~p).sum()),
            "only_program_share": float(norm(dp[p & ~q]) / norm(dp)),
            "only_reference_share": float(norm(dr[q & ~p]) / norm(dr)),
            "common_rel_diff": float(norm(dp[c] - dr[c]) / norm(dr[c])),
            "common_norm_gap": float(abs(norm(dp[c]) - norm(dr[c]))
                                     / norm(dr[c]))})
        acc_p += torch.where(c, dp, 0.0)
        acc_r += torch.where(c, dr, 0.0)
        sel_p |= p
        sel_r |= q
        prev_p, prev_r = wp, wr
    spans = [(path, o, n) for (path, _), (_, o, n) in
             zip(leaves(cell.config), offsets(leaves(cell.config)))]
    out = {"kind": "look", "seed": seed, "rounds": rows}
    for name, cp, rp in (("full", prog_w[-1], ref_w[-1]),
                         ("common", w0 + acc_p, w0 + acc_r)):
        detail = {}
        cand = {"losses": ref["losses"], "state": ref["state"],
                "params": cp.to(device)}
        vals = check.numbers(cell.config, tr, seed, cand,
                             {**ref, "params": rp.to(device)}, detail)
        worst = _worst_leaves(detail, 3)["delta"]
        for row in worst:
            _, o, n = next(s for s in spans if s[0] == row[0])
            sp, sr = sel_p[o:o + n], sel_r[o:o + n]
            row += [n, int(sp.sum()), int(sr.sum()), int((sp ^ sr).sum())]
        out[name] = {"delta_gap": vals["delta_gap"], "worst_leaves": worst}
    out["leaf_columns"] = ["path", "program norm", "reference norm",
                           "coordinates", "moved by the program",
                           "moved by the reference", "moved by one side"]
    return out


def _worst_leaves(detail: dict, n: int = 4) -> dict:
    """The ``n`` leaves of largest relative gap in the state and the
    change: ``[path, candidate norm, reference norm]``."""
    out = {}
    for key in ("state", "delta"):
        cand, ref = detail[key]
        order = sorted(range(len(ref)), key=lambda i: -abs(cand[i] - ref[i])
                       / max(ref[i], 1e-30))
        out[key] = [[detail["paths"][i], cand[i], ref[i]] for i in order[:n]]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--look-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark.harness.spec import load_cell
    from benchmark.run import _environment

    _environment()
    cell = load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for kind, seeds in (("program", args.program_seeds),
                        ("control", args.control_seeds),
                        ("half_batch", args.fault_seeds),
                        ("look", args.look_seeds)):
        for s in filter(None, seeds.split(",")):
            reading = (look(cell, int(s), "cuda") if kind == "look" else
                       readings(cell, int(s), kind, "cuda"))
            line = json.dumps({"workload": args.workload, **reading})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    if out is not None:
        out.close()


if __name__ == "__main__":
    main()
