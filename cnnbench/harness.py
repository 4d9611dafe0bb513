"""One run of one cell: set-up, the measured window, the check, the
result line.

The traffic file's ``arrivals`` picks how the window runs:

* ``"open"`` (:func:`serve_window`): independent users. Requests fall due
  on the generator's schedule; whenever some are due the harness hands
  all of them to ``CompiledCNN.serve`` (gang rounds of the compiled
  batch), and each request's latency is the host clock from its due time
  to the return of that call. A request that falls due while a call runs
  waits for the next one. The window ends when every request due within
  ``--seconds`` has come back.
* ``"closed"`` (:func:`offline_window`): a stored image set classified
  back to back: ``CompiledCNN.forward`` on a seeded rotation of batches
  already on the device, for ``--seconds``, ending in a synchronize. A
  seeded sample of the forwards keeps its logits for the check.

Set-up (``setup_s``, from the process's start to the window's) builds the
kernels (the first run in a checkout compiles them), draws the weights on
the device, compiles the model (calibration included), draws the inputs
and runs each shape the window uses once. With ``trace`` the window runs
under :mod:`cnnbench.devtrace`, and the per-layer metrics are read.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from cnnbench import check, config, counts, devtrace, program, traffic

MAX_FORWARDS = 1_000_000


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_window(compiled, pool: np.ndarray, mix: dict, seed: int,
                 seconds: float, phases: devtrace.PhaseLog) -> dict:
    """Serve an open mix's requests as they fall due; returns their due
    and return times (s, from the window's start), the served classes, and
    the engine's accounting summed over its calls."""
    due = traffic.arrivals(mix, seed, seconds)
    picks = traffic.picks(mix, seed, len(due))
    n = len(due)
    back = np.full(n, np.inf)
    preds = np.full(n, -1, dtype=np.int64)
    acct = {"calls": 0, "rounds": 0, "round_s": 0.0, "served": 0}
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while i < n:
        if due[i] > clock() - t0:
            phases.mark("waiting for the next arrival")
            while clock() - t0 < due[i]:
                pass
        j = int(np.searchsorted(due, clock() - t0, side="right"))
        phases.mark("CompiledCNN.serve")
        rep = compiled.serve(program.requests(pool, picks[i:j], range(i, j)))
        t_back = clock() - t0
        phases.mark("harness")
        for c in rep.completions:
            if c.status == "ok":
                back[c.rid] = t_back
                preds[c.rid] = c.pred
        acct["calls"] += 1
        acct["rounds"] += rep.rounds
        acct["round_s"] += rep.utilization[0] * rep.makespan_s \
            if rep.utilization else 0.0
        acct["served"] += rep.n_done
        i = j
    window_s = clock() - t0
    return {"due": due, "back": back, "picks": picks, "preds": preds,
            "window_s": window_s, **acct}


def offline_window(compiled, xs, mix: dict, seed: int, seconds: float,
                   phases: devtrace.PhaseLog) -> dict:
    """Forward the rotation back to back for ``seconds``; returns the
    forwards run, the window's length (to the final synchronize) and the
    kept ``(forward index, logits)``: the seeded sample and the last."""
    keep = traffic.keep_mask(mix, seed, MAX_FORWARDS)
    kept = []
    device = compiled.device
    _sync(device)
    phases.mark("CompiledCNN.forward")
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while clock() - t0 < seconds:
        y = compiled.forward(xs[i % len(xs)])
        if i < MAX_FORWARDS and keep[i]:
            kept.append((i, y))
        i += 1
    if i and (not kept or kept[-1][0] != i - 1):
        kept.append((i - 1, y))
    phases.mark("synchronize")
    _sync(device)
    return {"forwards": i, "window_s": clock() - t0, "kept": kept}


def _warm_serve(compiled, pool: np.ndarray, batch: int) -> None:
    """Every shape the serving window meets: a round of one request, a
    full round, and a call of two rounds."""
    for n in (1, batch, batch + 1):
        compiled.serve(program.requests(pool, np.arange(n) % len(pool),
                                        range(n)))


def control_model(cfg: dict, params, calib, batch: int, seed: int, device):
    """The control, compiled where the program would be: the nearest lower
    precision than the configuration states. A float configuration runs
    the program's own int8 path (its weights in fp32, calibrated on 128
    images of the seed); a fixed-point one, the reference one step lower
    (:class:`cnnbench.check.LowerReference`). Returns ``(model,
    seconds)``."""
    t0 = time.perf_counter()
    if check.ref_precision(cfg) in check.LOWER:
        return (check.LowerReference(cfg, params, calib, device),
                time.perf_counter() - t0)
    params = [None if p is None else {k: v.float() for k, v in p.items()}
              for p in params]
    low = {**cfg, "precision": {"dtype": "float32", "quant": "int8",
                                "calib_images": 128}}
    return program.compile_model(low, params, batch, device,
                                 calib=traffic.calib(cfg, seed, device,
                                                     n=128))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: Optional[float] = None, device=None,
             shrink: bool = False, readings: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run ``workload`` once; returns the result line's object. ``device``
    defaults to the CUDA device; the tests pass ``"cpu"`` and ``shrink``
    (the configuration at the size of :func:`cnnbench.config.shrink`).
    ``readings`` (a dict) receives every number the check computed, those
    without a limit too. ``control`` puts :func:`control_model` in the
    program's place (the benchmark's own runs never do): its ``correct``
    has to come out false."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = config.resolve(workload)
    cfg, mix = cell["config"], cell["traffic"]
    if shrink:
        cfg = config.shrink(cfg)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    phases = devtrace.PhaseLog()
    phases.mark("set-up")
    steps = {"process start to the harness": time.perf_counter() - t_start}

    def step(name):
        _sync(device)
        steps[name] = time.perf_counter() - t_start - sum(steps.values())

    # ---- set-up ----------------------------------------------------------
    if cuda:
        torch.zeros(1, device=device)
        step("CUDA context")
        program.build_kernels()
        step("kernel libraries (built on a checkout's first run)")
    params = traffic.model_weights(cfg, seed, device)
    calib = traffic.calib(cfg, seed, device)
    step("weights")
    if cuda:                        # the peak is the program's from here
        torch.cuda.reset_peak_memory_stats(device)
    if control:
        compiled, compile_s = control_model(cfg, params, calib, mix["batch"],
                                            seed, device)
    else:
        compiled, compile_s = program.compile_model(cfg, params,
                                                    mix["batch"], device,
                                                    calib=calib)
    del params, calib
    step("compile_cnn")
    if mix["arrivals"] == "open":
        pool = traffic.pool(cfg, mix, seed, device).cpu().numpy()
        step("inputs")
        _warm_serve(compiled, pool, mix["batch"])
    else:
        xs = [traffic.rotation(cfg, mix, seed, device, s)
              for s in range(mix["rotation"])]
        step("inputs")
        for x in xs[:2]:
            compiled.forward(x)
    if trace and cuda:
        devtrace.warm_profiler(device)
    step("warm-up")
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()),
          file=sys.stderr)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # ---- the window ------------------------------------------------------
    prof = devtrace.profiler() if trace and cuda else None
    if prof is not None:
        prof.start()
    t0_ns = time.time_ns()
    if mix["arrivals"] == "open":
        w = serve_window(compiled, pool, mix, seed, seconds, phases)
    else:
        w = offline_window(compiled, xs, mix, seed, seconds, phases)
    _sync(device)
    t1_ns = time.time_ns()
    tr = None
    if prof is not None:
        prof.stop()
        tr = devtrace.Trace(prof, t0_ns, t1_ns, phases)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ctx = {"setup_s": setup_s, "compile_s": compile_s, "trace": tr,
           "window_s": w["window_s"], "batch": mix["batch"]}
    if mix["arrivals"] == "open":
        lat = np.sort(w["back"] - w["due"])
        ctx.update(latencies_s=lat, rounds=w["rounds"],
                   round_s=w["round_s"], served=w["served"])
        attempted, failed = len(w["due"]), int(np.isinf(lat).sum())
    else:
        ctx.update(forwards=w["forwards"],
                   images=w["forwards"] * mix["batch"],
                   forward_ops=counts.forward_ops(cfg, mix["batch"]),
                   groups=counts.group_counts(cfg, mix["batch"]),
                   peak_ops=counts.peak_ops(cfg))
        attempted, failed = ctx["images"], 0
    metrics = config.read_metrics(
        cell["per_layer"] if trace else cell["end_to_end"], ctx)

    # ---- the check, after the program's state is freed --------------------
    kept = w.pop("kept", [])
    del compiled
    if mix["arrivals"] == "open":
        del pool
    else:
        del xs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if mix["arrivals"] == "open":
        numbers = check.served_numbers(cfg, mix, seed, device, w["picks"],
                                       w["preds"])
    else:
        numbers = check.offline_numbers(cfg, mix, seed, device, kept)
    del kept
    if readings is not None:
        readings.update(numbers)
    compared = {k: {"value": v, "limit": cell["limits"][k]["limit"]}
                for k, v in numbers.items() if k in cell["limits"]}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["compared"] = compared
    return out
