"""The port's static verifier (slice 7) against the JAX package's, on the
CPU: ``analysis/findings.py`` and ``analysis/plans.py``.

Mirrors ``tests/test_analysis.py`` (its lint half waits for slice 7b):
the ``RPA`` codes are JAX's; the port's fp32, int8 and bf16 artifacts and
compiles verify clean (``verify(strict=True)`` too) and a verification
runs no sweep and no measurement; every corruption JAX's tests make has
its port twin, flagged with JAX's code: a plan over its shared-memory
budget (RPA301, naming the row and the budget), a recorded
``smem_bytes`` the kernels' table disagrees with (RPA302), a tile whose
pooled patch overflows its rows and a split with more ranks than chunks
(RPA303), rows at the wrong dtype or parameters of the wrong precision
(RPA304), a group without a plan (RPA305), bad or unattributed
measurements (RPA306, also on the committed format-3 fixture) and a
broken artifact (RPA307). A row of another backend, such as the JAX
fixtures' ``"tpu"`` rows and a JAX-saved artifact's, is an RPA304
finding and never a silent pass; apart from those, the port's findings
on the committed fixtures are JAX's (none). The report document and the
baseline file round-trip and validate as JAX's do.
"""
import json
import re
from pathlib import Path

import jax
import pytest

from repro import analysis as janalysis
from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.models.cnn import init_cnn_params as jax_init_cnn_params
from repro.obs import validate_analysis as jvalidate_analysis
from repro_torch.analysis import (CODES, Finding, baseline_doc,
                                  load_baseline, report_doc,
                                  verify_artifact, verify_compiled,
                                  verify_plan_table)
from repro_torch.analysis.findings import split_baseline
from repro_torch.configs import get_config
from repro_torch.kernels import autotune
from repro_torch.obs import validate_analysis
from repro_torch.pipeline import (ExecutionSpec, Placement, PlanTable,
                                  Precision, Serving, compile_cnn)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
MODES = {"fp32": Precision(), "int8": Precision(quant="int8"),
         "bf16": Precision(dtype="bfloat16")}


@pytest.fixture(scope="module")
def compiled():
    cfg = get_config("alexnet").smoke()
    return {m: compile_cnn(cfg, ExecutionSpec(precision=p,
                                              serving=Serving(batch=4)),
                           device="cpu") for m, p in MODES.items()}


@pytest.fixture
def artifact(compiled, tmp_path):
    def save(mode="fp32"):
        p = tmp_path / f"art_{mode}"
        compiled[mode].save(p)
        return p
    return save


def _codes(findings):
    return sorted({f.code for f in findings})


def _edit_table(path, edit):
    doc = json.loads((path / "plan_table.json").read_text())
    edit(doc)
    (path / "plan_table.json").write_text(
        json.dumps(doc, sort_keys=True, indent=1) + "\n")


def test_codes_are_jaxs():
    assert set(CODES) == set(janalysis.CODES)
    assert all(re.fullmatch(r"RPA\d{3}", c) and CODES[c] for c in CODES)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_ports_artifacts_and_compiles_verify_clean(compiled, artifact,
                                                       mode):
    c = compiled[mode]
    sweep0, meas0 = autotune.sweep_stats(), autotune.measure_stats()
    assert verify_artifact(artifact(mode)) == []
    assert c.verify() == [] and c.verify(strict=True) == []
    assert verify_compiled(c) == []
    assert autotune.sweep_stats() == sweep0
    assert autotune.measure_stats() == meas0


@pytest.mark.parametrize("placement", [(2, 1, 0), (1, 3, 4), (2, 2, 2)],
                         ids=["dp", "pp", "hybrid"])
def test_fleet_compiles_verify_clean(placement):
    R, S, M = placement
    c = compile_cnn(get_config("alexnet").smoke(), ExecutionSpec(
        placement=Placement(replicas=R, pp_stages=S, microbatches=M)),
        device="cpu")
    assert c.verify(strict=True) == []


def test_oversized_plan_is_rpa301_naming_row_and_budget(artifact):
    """The port's twin of JAX's 494-MiB conv row: a 128x128 fp32 tile
    (67584 B) declared under a 32 KiB budget."""
    p = artifact()
    doc = json.loads((p / "plan_table.json").read_text())
    row = dict(doc["conv"][0], vmem_budget=32768,
               plan=dict(doc["conv"][0]["plan"], tp=128, tn=128,
                         smem_bytes=67584))
    idx = len(doc["conv"])
    _edit_table(p, lambda d: d["conv"].append(row))
    f = [f for f in verify_artifact(p) if f.code == "RPA301"]
    assert len(f) == 1 and f"conv[{idx}]" in f[0].path
    assert "32768" in f[0].message and "needs 67584 B" in f[0].message
    # a budget over the card's opt-in limit a block is read as the limit
    assert verify_plan_table(PlanTable.from_rows(
        [dict(row, vmem_budget=1 << 30)], [])) == []


@pytest.mark.parametrize("mode", sorted(MODES))
def test_smem_bytes_past_the_budget_is_caught(artifact, mode):
    p = artifact(mode)

    def edit(d):
        d["conv"][1]["plan"]["smem_bytes"] = d["conv"][1]["vmem_budget"] + 1
        d["gemm"][0]["plan"]["smem_bytes"] += 16
    _edit_table(p, edit)
    found = [f for f in verify_artifact(p) if f.code in ("RPA301",
                                                          "RPA302")]
    # the table re-sorts its rows on load: one conv and one gemm finding
    assert sorted((f.code, f.path.split("#")[1][:4]) for f in found) == [
        ("RPA302", "conv"), ("RPA302", "gemm")]


def test_geometry_and_spec_mismatches():
    c = compile_cnn(get_config("vgg16").smoke(), device="cpu")
    conv = max((r for r in c.plans().conv if r["shape"]["pool"]),
               key=lambda r: r["shape"]["h"])          # conv1_2 + pool
    gemm = c.plans().gemm[0]
    # a pooled patch over the tile's rows (the JAX test's pool_s case):
    # 5 x 5 pooled outputs of a 2x2/2 pool need 10 x 10 conv positions
    bad = dict(conv, plan=dict(conv["plan"], tp=64, tph=5, tpw=5))
    f = verify_plan_table(PlanTable.from_rows([bad], []))
    assert _codes(f) == ["RPA303"] and "64 rows" in f[0].message
    # a tile no kernel is instantiated at
    f = verify_plan_table(PlanTable.from_rows(
        [dict(conv, plan=dict(conv["plan"], tn=96))], []))
    assert _codes(f) == ["RPA303"]
    # more ranks than the cluster takes
    f = verify_plan_table(PlanTable.from_rows(
        [], [dict(gemm, plan=dict(gemm["plan"], ranks=9))]))
    assert _codes(f) == ["RPA303"] and "ranks" in f[0].message
    # an fp32 row under an int8 spec, and under another budget
    spec = ExecutionSpec(precision=Precision(quant="int8"))
    f = verify_plan_table(PlanTable.from_rows([conv], []), spec=spec)
    assert _codes(f) == ["RPA304"] and "int8" in f[0].message
    f = verify_plan_table(PlanTable.from_rows([conv], []),
                          spec=ExecutionSpec())
    assert f == []


def test_unattributed_and_bad_measurements_are_rpa306():
    c = compile_cnn(get_config("alexnet").smoke(), device="cpu")
    row = dict(c.plans().conv[0], measured={"t_measured": -1.0})
    t = PlanTable.from_rows([row], [], provenance={"source": "registry"})
    f = [f for f in verify_plan_table(t) if f.code == "RPA306"]
    assert len(f) == 2 and any("fingerprint" in x.message for x in f)
    twin = dict(row, measured={"t_measured": 2.0})
    t = PlanTable(conv=(dict(row, measured={"t_measured": 1.0}), twin))
    assert any("ambiguous" in x.message for x in verify_plan_table(t))


def test_coverage_and_stages_are_rpa305(compiled, artifact):
    p = artifact()
    _edit_table(p, lambda d: d["gemm"].pop(0))
    f = verify_artifact(p)
    assert _codes(f) == ["RPA305"] and "no plan row" in f[0].message

    class Skewed:
        cfg, spec = compiled["fp32"].cfg, compiled["fp32"].spec
        stages = (((0,),), ((0,),))

        def plans(self):
            return compiled["fp32"].plans()
    assert any(x.code == "RPA305" and "stage plan" in x.message
               for x in verify_compiled(Skewed()))


def test_params_and_structure_are_rpa304_and_rpa307(artifact, tmp_path):
    p = artifact("int8")
    man = json.loads((p / "manifest.json").read_text())
    man["spec"]["precision"]["quant"] = "none"
    (p / "manifest.json").write_text(json.dumps(man))
    assert "RPA304" in _codes(verify_artifact(p))
    p = artifact("fp32")
    (p / "leaf_0.npy").unlink()
    assert any(f.code == "RPA307" and "leaf_0.npy" in f.message
               for f in verify_artifact(p))
    (p / "_COMMITTED").unlink()
    assert any(f.code == "RPA307" and "_COMMITTED" in f.message
               for f in verify_artifact(p))
    assert _codes(verify_artifact(tmp_path / "nowhere")) == ["RPA307"]
    man = json.loads((p / "manifest.json").read_text())
    man["spec"]["serving"]["batch"] = 0
    (p / "manifest.json").write_text(json.dumps(man))
    assert any(f.code == "RPA307" and "Serving.batch" in f.message
               for f in verify_artifact(p))


def test_a_jax_artifact_is_flagged_row_by_row(tmp_path):
    """A JAX artifact loads into the port, but its ``"tpu"`` rows are
    findings: no CUDA kernel takes a Pallas blocking."""
    jcfg = jax_get_config("alexnet").smoke()
    jc = jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(
        serving=jpipe.Serving(batch=4)),
        jax_init_cnn_params(jax.random.key(1), jcfg))
    jc.save(tmp_path / "jax")
    assert janalysis.verify_artifact(tmp_path / "jax") == []
    f = verify_artifact(tmp_path / "jax")
    assert {x.code for x in f} == {"RPA304", "RPA305"}
    assert sum("'tpu'" in x.message for x in f) == len(jc.plans())


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_fixtures_are_jaxs_findings_plus_their_backend(fmt):
    table = PlanTable.from_json(
        (FIXTURES / f"plan_table_format{fmt}.json").read_text())
    jtable = jpipe.PlanTable.from_json(
        (FIXTURES / f"plan_table_format{fmt}.json").read_text())
    f = verify_plan_table(table, path=f"fixtures/format{fmt}")
    backend = [x for x in f if "'tpu'" in x.message]
    assert [x.code for x in backend] == ["RPA304"] * len(table)
    assert [x for x in f if x not in backend] == \
        janalysis.verify_plan_table(jtable) == []


def test_fixture_format3_corruption_is_rpa306_as_in_jax():
    doc = json.loads((FIXTURES / "plan_table_format3.json").read_text())
    doc["conv"][0]["measured"]["t_measured"] = 0.0
    f = verify_plan_table(PlanTable.from_json(json.dumps(doc)))
    jf = janalysis.verify_plan_table(jpipe.PlanTable.from_json(
        json.dumps(doc)))
    assert [x.to_dict() for x in f if x.code != "RPA304"] == \
        [x.to_dict() for x in jf]
    assert [x.code for x in jf] == ["RPA306"]


def test_report_and_baseline_documents_equal_jaxs(tmp_path):
    f = Finding("RPA301", "plan_table#conv[0]", 0, "over budget")
    jf = janalysis.Finding("RPA301", "plan_table#conv[0]", 0, "over budget")
    verify = {"artifact": None, "plan_table": "t.json", "n_findings": 1}
    doc = report_doc(findings=[f], verify=verify)
    jdoc = janalysis.report_doc(findings=[jf], verify=verify)
    assert doc == dict(jdoc, tool="repro_torch.analysis")
    assert validate_analysis(doc) == [] and jvalidate_analysis(jdoc) == []
    assert validate_analysis(dict(doc, n_findings=7))
    assert validate_analysis(dict(doc, findings=[dict(f.to_dict(),
                                                      code="OOPS")]))
    assert validate_analysis(jdoc)          # another tool's report
    assert str(f) == str(jf) and f.key() == jf.key()
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps(baseline_doc([f]), sort_keys=True))
    assert baseline_doc([f]) == janalysis.baseline_doc([jf])
    assert load_baseline(bl) == {f.key()}
    assert split_baseline([f], load_baseline(bl)) == ([], [f])
    bl.write_text(json.dumps({"format": 99, "findings": []}))
    with pytest.raises(ValueError, match="format"):
        load_baseline(bl)


def test_verify_strict_raises_a_spec_error(compiled, monkeypatch):
    from repro_torch.core.config import SpecError
    c = compiled["fp32"]
    bad = PlanTable.from_rows([dict(c.plans().conv[0], vmem_budget=1024)],
                              list(c.plans().gemm))
    monkeypatch.setattr(c, "plan_table", bad)
    with pytest.raises(SpecError) as e:
        c.verify(strict=True)
    assert e.value.field == "plan_table" and "RPA301" in str(e.value)
    assert {x.code for x in c.verify()} >= {"RPA301", "RPA304", "RPA305"}
