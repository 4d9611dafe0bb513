"""Perf hill climb: hypothesis -> change -> re-trace -> re-analyse.

The JAX package's ``launch/hillclimb.py`` over the port's dry run. Each
iteration is (name, hypothesis, cfg/rule overrides), JAX's ``PLANS``
verbatim; each runs :func:`repro_torch.launch.dryrun.run_cell` on the
single-pod mesh with its overrides (JAX runs its layer extrapolation,
which the port does not need: its trace runs every layer), lands in
``experiments/hillclimb_torch/<cell>__<iter>.json``, and prints the
before/after deltas. The hypotheses are JAX's, written about XLA on a
TPU; the port's numbers test them against DTensor's layout and the
card's rates.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen3_8b_train
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR, run_cell

OUT = Path(__file__).resolve().parents[3] / "experiments" / "hillclimb_torch"

# (iteration name, hypothesis, cfg_over, rules_over)
PLANS = {
    # most representative of the paper's technique (dense GEMM pipeline)
    "qwen3_8b_train": ("qwen3-8b", "train_4k", [
        ("it1_dots_remat",
         "full remat re-runs the whole fwd in bwd: ~1/3 of compute AND the "
         "re-issued FSDP all-gathers are recompute. Saving dot outputs "
         "(dots_with_no_batch_dims) should cut T_comp ~25%, T_coll ~30%, "
         "T_mem ~25% at higher activation residency.",
         {"remat_policy": "dots"}, {}),
        ("it2_dots_chunk2k",
         "larger online-softmax KV chunks (1k->2k) halve the number of "
         "chunk-boundary m/l rescale passes over the (B,S,heads) running "
         "stats: fewer elementwise IO bytes, same FLOPs.",
         {"remat_policy": "dots", "attn_chunk": 2048}, {}),
        ("it3_dots_seqshard",
         "Megatron-style sequence parallelism: shard the activation seq dim "
         "over the TP axis between blocks so norms/elementwise IO is 1/16 "
         "per device; adds gather/scatter at block edges (T_coll up a bit, "
         "T_mem down).",
         {"remat_policy": "dots"}, {"seq": ("model",)}),
        ("it4_final_bf16_attn",
         "same config re-measured after the global mixed-precision "
         "attention change (bf16 operands, f32 accumulation) landed in "
         "models/attention.py — isolates that change's effect on the best "
         "train config.",
         {"remat_policy": "dots"}, {"seq": ("model",)}),
    ]),
    # most collective-bound cell (MoE dispatch)
    "dbrx_train": ("dbrx-132b", "train_4k", [
        ("it1_local_capacity",
         "the global-capacity dispatch scatters tokens into capacity slots "
         "sharded over data — token->slot is arbitrary, so GSPMD moves the "
         "whole (E,C,D) buffer across shards per layer. Grouping tokens by "
         "data shard with per-group capacity makes scatter/gather "
         "shard-local: T_coll should drop ~5-10x.",
         {"moe_groups": 16}, {}),
        ("it2_local_cap_dots",
         "on top of it1, dots-remat removes the bwd re-gather of expert "
         "weights (the remaining dominant all-gather).",
         {"moe_groups": 16, "remat_policy": "dots"}, {}),
        ("it3_local_cap_dots_seqshard",
         "add sequence-parallel activations (the qwen3-8b it3 win) to the "
         "MoE cell: norms/elementwise/router IO 1/16 per device.",
         {"moe_groups": 16, "remat_policy": "dots"}, {"seq": ("model",)}),
    ]),
    # worst roofline-fraction class: decode (serving — the paper's own kind)
    "qwen3_32b_decode": ("qwen3-32b", "decode_32k", [
        ("it2_masked_cache_write",
         "point decomposition: per-layer decode bytes are 1.9 GiB/dev vs a "
         "0.06 GiB cache slice — dynamic_update_slice at a runtime position "
         "along the MODEL-SHARDED seq axis forces GSPMD to all-gather the "
         "whole cache per layer. A masked where-write is elementwise and "
         "shard-local: expect per-layer bytes ~6x down, T_mem -80%.",
         {}, {}),
        ("it1_bf16_attn_accum",
         "HLO attribution shows 4.7 GiB/dev of bf16->f32 CONVERTS — the "
         "attention math upcasts the whole KV cache slice to f32 (repeated "
         "across fusions). bf16 operands with preferred_element_type=f32 "
         "accumulation (native MXU behaviour) should remove the converts "
         "and roughly halve cache-read bytes: expect T_mem down 30-50%.",
         {}, {}),
    ]),
}


def _baseline(arch: str, shape: str):
    """The dry run's single-pod baseline of the cell, if one was written
    (``python -m repro_torch.launch.dryrun``, default tag), under the
    arch's id or its alias."""
    for name in (arch.replace("-", "_").replace(".", "p"), arch):
        f = DRYRUN_DIR / f"baseline__{name}__{shape}__pod16x16.json"
        if f.exists():
            return json.loads(f.read_text())
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(PLANS) + ["all"], default="all")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)

    cells = list(PLANS) if args.cell == "all" else [args.cell]
    for cell in cells:
        arch, shape, iters = PLANS[cell]
        base = _baseline(arch, shape)
        if base:
            print(f"\n=== {cell} baseline: T_comp={base['t_compute']*1e3:.1f} "
                  f"T_mem={base['t_memory']*1e3:.1f} "
                  f"T_coll={base['t_collective']*1e3:.1f} ms "
                  f"bound={base['bottleneck']} ===")
        prev = base
        for name, hypothesis, cfg_over, rules_over in iters:
            out_file = OUT / f"{cell}__{name}.json"
            if args.skip_existing and out_file.exists():
                prev = json.loads(out_file.read_text())
                print(f"[skip] {name}")
                continue
            print(f"\n--- {cell} / {name} ---\nHYPOTHESIS: {hypothesis}")
            res = run_cell(arch, shape, False, cfg_over=cfg_over,
                           rules_over=rules_over)
            res["hypothesis"] = hypothesis
            res["cfg_over"] = cfg_over
            res["rules_over"] = {k: list(v) if isinstance(v, tuple) else v
                                 for k, v in rules_over.items()}
            out_file.write_text(json.dumps(res, sort_keys=True, indent=1))
            if prev:
                for k in ("t_compute", "t_memory", "t_collective"):
                    d = res[k] / max(prev[k], 1e-12) - 1
                    print(f"   {k}: {prev[k]*1e3:9.1f} -> {res[k]*1e3:9.1f} ms"
                          f" ({d:+.1%})")
            prev = res
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
