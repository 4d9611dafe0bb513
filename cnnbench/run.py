#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the repository's root:

    python3 cnnbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``compared`` (each number beside its limit) comes last.

Exits non-zero, printing no result, without a CUDA device, without the
port (``src/repro_torch``) beside it, or if JAX or the JAX package was
loaded by the time the window closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None):
    """Top-level names of loaded modules (``sys.modules``' by default) that
    belong to JAX or the JAX package, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cnnbench.host import fix_malloc
    fix_malloc()
    # every cache of the run at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "cnnbench" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("cnnbench: the port (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2

    import torch
    from cnnbench import config, harness

    cell = config.resolve(args.workload)["cell"]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cnnbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"cnnbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
