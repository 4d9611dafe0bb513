#!/usr/bin/env python3
"""Runs of one cell, each in a fresh process as a check makes them, and
the spread of each metric: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 cnnbench/sets.py --workload W --seeds 11,12,13 --seconds 10 \\
        [--trace 0|1] [--repeat 2]

``--repeat 2`` runs the same seeds twice, one set after the other (the two
sets a bound is set from). Every run's last line goes to ``--out``
(default ``build/cnnbench/sets/<workload>.jsonl``) with its seed, set,
exit code and set-up steps; the spreads are printed per set, with the
widest of the sets.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = Path(args.out or ROOT / "build" / "cnnbench" / "sets"
               / f"{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for rep in range(args.repeat):
        runs = []
        for seed in seeds:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, str(ROOT / "cnnbench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            res = json.loads(lines[-1]) if p.returncode == 0 and lines \
                else None
            rec = {"set": rep, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": res,
                   "setup_steps": [l for l in p.stderr.splitlines()
                                   if l.startswith("set-up:")]}
            if res is None:
                rec["stderr"] = p.stderr[-3000:]
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            brief = {k: round(v["value"], 4)
                     for k, v in (res or {}).get("metrics", {}).items()}
            print(f"set {rep} seed {seed} rc {p.returncode} wall "
                  f"{wall:.1f}s correct "
                  f"{res and res['correct']} {brief} "
                  f"{res and res['compared']}", flush=True)
            if res is None:
                print(p.stderr[-3000:], flush=True)
            runs.append(res)
        sets.append(runs)
    names = sorted({k for runs in sets for r in runs if r
                    for k in r["metrics"]})
    for name in names:
        per = []
        for runs in sets:
            vals = [r["metrics"][name]["value"] for r in runs
                    if r and name in r["metrics"]]
            per.append((statistics.median(vals) if vals else None,
                        spread(vals)))
        widest = max((s for _, s in per if s is not None), default=None)
        print(f"{name}: " + "; ".join(
            f"set {i} median {m!r} spread {s!r}" for i, (m, s)
            in enumerate(per)) + f"; widest {widest!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
