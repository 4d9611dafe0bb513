"""The frozen plan table: a compiled pipeline's DSE results as data.

PipeCNN's offline sweep fixes a (VEC_SIZE, CU_NUM) point that is baked
into the bitstream; here the fixed points are the tile of every conv
launch and the split of every FC launch a compiled pipeline looks up
(:mod:`repro_torch.kernels.autotune`), captured at compile time
(``autotune.record_lookups``) and serialised to the JAX package's JSON
document, row for row in its format: ``shape`` / ``backend`` /
``vmem_budget`` / ``plan``, with the port's backend tags
(``cuda:sm_90:132``) and plan fields (``tp``/``tn``/``tph``/``tpw`` or
``tnf``/``ranks``). A table round-trips byte-identically
(``from_json(tbl.to_json()).to_json() == tbl.to_json()``) and, loaded into
a fresh process, seeds the registries so a re-compile runs no sweep.

Document formats (all load): 1, the ``conv`` / ``gemm`` row lists; 2 adds
``provenance`` (carried verbatim, excluded from equality); 3 adds per-row
``measured`` dicts (``t_measured`` seconds a call and the harness that
took it, from ``repro_torch.obs.profiler``), with the backend fingerprint
in ``provenance["measurement"]``. A JAX table (backend ``"tpu"``) loads
and round-trips but seeds nothing: no TPU blocking reaches a CUDA kernel.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import autotune

_FORMAT = 3
_ACCEPTED_FORMATS = (1, 2, 3)

# the row fields that identify WHAT a plan entry is (everything but its
# measurement): the join key between a plan row and its measured record
_KEY_FIELDS = ("shape", "backend", "vmem_budget", "plan")


def plan_key(row: dict) -> str:
    """Canonical identity of one plan row: the sorted JSON of its
    shape/backend/vmem_budget/plan fields, as the JAX package writes it."""
    return json.dumps({k: row[k] for k in _KEY_FIELDS}, sort_keys=True)


def _canon(rows: List[dict]) -> Tuple[dict, ...]:
    """Deduplicate + deterministically order snapshot records."""
    seen = {}
    for row in rows:
        seen[json.dumps(row, sort_keys=True)] = row
    return tuple(seen[k] for k in sorted(seen))


@dataclass(frozen=True, eq=True)
class PlanTable:
    """Immutable, JSON-round-trippable set of plans."""
    conv: Tuple[dict, ...] = ()
    gemm: Tuple[dict, ...] = ()
    # how the plans were obtained; identical plans make identical tables
    # whether a compile swept or was seeded
    provenance: dict = field(default_factory=dict, compare=False)

    @classmethod
    def from_rows(cls, conv: List[dict], gemm: List[dict],
                  provenance: Optional[dict] = None) -> "PlanTable":
        return cls(conv=_canon(conv), gemm=_canon(gemm),
                   provenance=dict(provenance or {}))

    @classmethod
    def from_registry(cls, provenance: Optional[dict] = None
                      ) -> "PlanTable":
        """Snapshot the process registries as one table; provenance
        defaults to the live sweep counters."""
        if provenance is None:
            provenance = {"source": "registry",
                          "sweep_stats": autotune.sweep_stats()}
        return cls.from_rows(autotune.registry_snapshot(),
                             autotune.gemm_registry_snapshot(),
                             provenance=provenance)

    def __len__(self) -> int:
        return len(self.conv) + len(self.gemm)

    # -- (de)serialisation -------------------------------------------------

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, deterministic row order."""
        return json.dumps({"format": _FORMAT,
                           "conv": list(self.conv),
                           "gemm": list(self.gemm),
                           "provenance": self.provenance},
                          sort_keys=True, indent=1) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "PlanTable":
        doc = json.loads(text)
        if doc.get("format") not in _ACCEPTED_FORMATS:
            raise ValueError(
                f"plan table format {doc.get('format')!r} not in "
                f"{_ACCEPTED_FORMATS}; re-save with CompiledCNN.save_plan")
        return cls.from_rows(doc["conv"], doc["gemm"],
                             provenance=doc.get("provenance", {}))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "PlanTable":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- registry seeding --------------------------------------------------

    def seed(self) -> int:
        """Insert the port's plans (rows with a port backend tag) into the
        process registries; keys already there win. Returns the number
        inserted. After seeding, a ``compile_cnn`` over the same spec runs
        no sweep."""
        return autotune.seed_registry(self.conv, self.gemm)

    # -- measurements (format 3) -------------------------------------------

    def measurements(self) -> Dict[str, dict]:
        """``plan_key(row) -> measured`` for every measured row (conv and
        gemm shapes have disjoint fields, so keys cannot collide)."""
        out: Dict[str, dict] = {}
        for rows in (self.conv, self.gemm):
            for row in rows:
                if "measured" in row:
                    out[plan_key(row)] = row["measured"]
        return out

    def with_measurements(self, measured: Dict[str, dict],
                          provenance: Optional[dict] = None
                          ) -> "PlanTable":
        """A new table with ``measured`` records attached by plan key;
        ``provenance`` replaces the table's when given. With neither, the
        table itself."""
        if not measured and provenance is None:
            return self

        def attach(rows):
            out = []
            for row in rows:
                m = measured.get(plan_key(row))
                if m is not None:
                    row = {k: v for k, v in row.items() if k != "measured"}
                    row["measured"] = dict(m)
                out.append(row)
            return out

        return PlanTable.from_rows(
            attach(self.conv), attach(self.gemm),
            provenance=self.provenance if provenance is None
            else provenance)

    def summary(self) -> Dict[str, int]:
        d = {"conv_plans": len(self.conv), "gemm_plans": len(self.gemm)}
        n_measured = len(self.measurements())
        if n_measured:
            d["measured_plans"] = n_measured
        return d


def load_plan(path: str) -> PlanTable:
    """Load a saved plan table (``CompiledCNN.save_plan`` output)."""
    return PlanTable.load(path)
