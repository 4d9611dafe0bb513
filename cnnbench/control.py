#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size, in
one process on the card:

    python3 cnnbench/control.py --workload W --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --seconds 5

Each reading is a run of the cell (``harness.run_cell``: set-up, a short
window at the cell's own load, the check and its ``correct``):

* the program's, on each of ``--seeds``;
* the control's, on each of ``--control-seeds``: the same run with the
  nearest lower precision in the program's place
  (:func:`cnnbench.harness.control_model`).

Prints one JSON line a run (every number the check computed, and
``correct``), then the largest program reading and the smallest control
reading of each number, and writes them all to ``--out`` (default
``build/cnnbench/control/<workload>.json``). Exits 1 if a program run
came out not correct or a control run correct.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from cnnbench.host import fix_malloc
    fix_malloc()
    import torch
    from cnnbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    prog, ctrl = [], []
    for who, seeds, runs in (("program", args.seeds, prog),
                             ("control", args.control_seeds, ctrl)):
        for seed in [int(s) for s in seeds.split(",")]:
            numbers = {}
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   readings=numbers,
                                   control=who == "control")
            rec = {"who": who, "seed": seed, "correct": out["correct"],
                   **numbers, "metrics": {k: v["value"] for k, v
                                          in out["metrics"].items()}}
            runs.append(rec)
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    names = sorted(k for k in ctrl[0] if k not in ("who", "seed", "correct",
                                                    "metrics"))
    summary = {n: {"lower": max(r[n] for r in prog),
                   "upper": min(r[n] for r in ctrl)} for n in names}
    res = {"workload": args.workload, "card": torch.cuda.get_device_name(),
           "seconds": args.seconds, "summary": summary,
           "program": prog, "control": ctrl}
    path = Path(args.out or ROOT / "build" / "cnnbench" / "control"
                / f"{args.workload}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    print(json.dumps({"summary": summary}))
    return 0 if all(r["correct"] for r in prog) \
        and not any(r["correct"] for r in ctrl) else 1


if __name__ == "__main__":
    sys.exit(main())
