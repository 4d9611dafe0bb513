#!/usr/bin/env python3
"""The knee sweep of an open cell: the highest offered rate the program
sustains, below which the traffic file's ``rate_per_s`` was fixed
(PERF.md section 4 has the sweeps and the choice). Run on the card:

    python3 cnnbench/sweep.py --workload vgg16_bf16.serve_b8 \\
        --rates 500,600,700,800,900,1000 --seconds 10 --seed 7

One process sets the cell up once and serves each rate's window in turn
(the harness's own ``serve_window``, the traffic file's mix with only the
rate changed). Per rate it prints one JSON line: requests, p50, p95 and
p99 (ms), the mean latency of each quarter of the window by due time, the
drain (seconds past the window that the last requests took), the rounds
and their fill. A rate is sustained where the p99 meets ``--slo-ms``
(MLPerf Inference's Server bound for image classification: 15 ms at the
99th percentile) and the backlog does not grow (the last quarter's mean
latency under twice the second's, the drain under a second); the knee is
the highest rate below the first one that is not.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=15.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "cnnbench"
                                         / "sweep.json"))
    args = ap.parse_args(argv)

    from cnnbench.host import fix_malloc
    fix_malloc()
    import numpy as np
    import torch
    from cnnbench import config, devtrace, harness, program, traffic

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = config.resolve(args.workload)
    cfg, mix = cell["config"], cell["traffic"]
    dev = torch.device("cuda")
    program.build_kernels()
    compiled, _ = program.compile_model(
        cfg, traffic.model_weights(cfg, args.seed, dev), mix["batch"], dev,
        calib=traffic.calib(cfg, args.seed, dev))
    pool = traffic.pool(cfg, mix, args.seed, dev).cpu().numpy()
    for n in (1, mix["batch"], mix["batch"] + 1):
        compiled.serve(program.requests(pool, np.arange(n), range(n)))
    rows, knee, missed = [], None, False
    for rate in [float(r) for r in args.rates.split(",")]:
        w = harness.serve_window(compiled, pool, {**mix, "rate_per_s": rate},
                                 args.seed, args.seconds,
                                 devtrace.PhaseLog())
        lat = w["back"] - w["due"]
        q = np.array_split(lat, 4)
        s = np.sort(lat)
        row = {"rate_per_s": rate, "requests": len(lat),
               "p50_ms": float(s[int(np.ceil(0.5 * len(s))) - 1] * 1e3),
               "p95_ms": float(s[int(np.ceil(0.95 * len(s))) - 1] * 1e3),
               "p99_ms": float(s[int(np.ceil(0.99 * len(s))) - 1] * 1e3),
               "quarter_mean_ms": [float(x.mean() * 1e3) for x in q],
               "drain_s": w["window_s"] - args.seconds,
               "calls": w["calls"], "rounds": w["rounds"],
               "fill": w["served"] / max(1, w["rounds"] * mix["batch"]),
               "round_ms": w["round_s"] / max(1, w["rounds"]) * 1e3}
        row["backlog_grows"] = bool(
            row["quarter_mean_ms"][3] > 2 * row["quarter_mean_ms"][1]
            or row["drain_s"] > 1.0)
        row["sustained"] = not row["backlog_grows"] \
            and row["p99_ms"] <= args.slo_ms
        if not row["sustained"]:
            missed = True
        elif not missed:
            knee = rate
        rows.append(row)
        print(json.dumps(row), flush=True)
    res = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "slo_p99_ms": args.slo_ms,
           "card": torch.cuda.get_device_name(),
           "knee_rate_per_s": knee,
           "rate_at_80_percent": None if knee is None else 0.8 * knee,
           "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
