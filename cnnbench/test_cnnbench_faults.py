"""The check sees the faults a cell can have, and its control fails.

Each fault test drives the rest of a run (``harness.run_cell`` on the CPU,
skipping the look for a card) with the program broken underneath, and
wants ``correct`` to come out false:

* stale: a step returns what the one before it returned;
* half the batch left out: a step computes only the first half of its
  rows (the rest are blank images);
* an answer altered where it is produced: one request's class a round
  shifted by one (serve), or one row's logits a forward negated
  (offline).

(There is no exchange between chips to leave out: every cell runs on one.)
The control tests put the nearest lower precision in the program's place
(``run_cell(control=True)``) and want ``correct`` to come out false: at a
size a test run holds, and at the cell's own on the card.
"""
import pytest
from repro_torch.pipeline.compile import CompiledCNN
from repro_torch.serve.engine import ServeEngine

from cnnbench import check, config, harness, traffic

SERVE, OFFLINE = "vgg16_bf16.serve_b8", "alexnet_int8.offline_b128"
OFFLINE_BF16 = "vgg16_bf16.offline_b64"


def _run(cell, seed=2 ** 31 + 17):
    return harness.run_cell(cell, seed, 0.3, False, device="cpu",
                            shrink=True)


def _serve_fault(kind):
    real = ServeEngine._round_preds
    state = {}

    def broken(self, packed, versions):
        if kind == "half":
            packed = packed.copy()
            packed[len(packed) // 2:] = 0.0
        preds = real(self, packed, versions)
        if kind == "stale":
            prev, state["prev"] = state.get("prev"), preds
            return prev if prev is not None else preds
        if kind == "altered":
            preds = preds.copy()
            preds[0, 0] = (preds[0, 0] + 1) % self.cfg.n_classes
        return preds
    return broken


def _forward_fault(kind):
    real = CompiledCNN.forward
    state = {}

    def broken(self, x):
        if kind == "half":
            x = x.clone()
            x[len(x) // 2:] = 0.0
        y = real(self, x)
        if kind == "stale":
            prev, state["prev"] = state.get("prev"), y
            return prev if prev is not None else y
        if kind == "altered":
            y = y.clone()
            y[0] = -y[0]
        return y
    return broken


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_serve_check_sees_the_fault(kind, monkeypatch):
    assert _run(SERVE)["correct"] is True
    monkeypatch.setattr(ServeEngine, "_round_preds", _serve_fault(kind))
    out = _run(SERVE)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_offline_check_sees_the_fault(kind, monkeypatch):
    monkeypatch.setattr(CompiledCNN, "forward", _forward_fault(kind))
    out = _run(OFFLINE)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_bf16_offline_check_sees_the_fault(kind, monkeypatch):
    assert _run(OFFLINE_BF16)["correct"] is True
    monkeypatch.setattr(CompiledCNN, "forward", _forward_fault(kind))
    out = _run(OFFLINE_BF16)
    assert out["correct"] is False, out["compared"]


def _published_classes(monkeypatch):
    """The bf16 checks at the test size read a gap among the published
    1,000 classes (and the served one over a pool of 1,024 images), so
    that the small model's fewer near-ties show: its last FC widened
    back, its pool widened."""
    shrink, resolve = config.shrink, config.resolve

    def wide(cfg):
        small = shrink(cfg)
        ls = [dict(l) for l in small["layers"]]
        ls[-1]["out_ch"] = cfg["n_classes"]
        return {**small, "layers": ls, "n_classes": cfg["n_classes"]}

    def wide_pool(workload, bench=None):
        r = resolve(workload, bench)
        return {**r, "traffic": {**r["traffic"], "pool": 1024}}
    monkeypatch.setattr(config, "shrink", wide)
    monkeypatch.setattr(config, "resolve", wide_pool)


@pytest.mark.parametrize("cell", [SERVE, OFFLINE, OFFLINE_BF16])
def test_the_control_fails_the_cells_limit(cell, monkeypatch):
    """The control in the program's place (``run_cell(control=True)``),
    through the window and the comparison of a run, comes out not
    correct; the program at the same size, correct."""
    seconds = 0.3
    if cell in (SERVE, OFFLINE_BF16):
        _published_classes(monkeypatch)
    if cell == SERVE:
        seconds = 2.0
    run = lambda seed, control: harness.run_cell(
        cell, seed, seconds, False, device="cpu", shrink=True,
        control=control)
    assert run(1, False)["correct"] is True
    for seed in (1, 2, 3):
        out = run(seed, True)
        assert out["correct"] is False, out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [SERVE, OFFLINE, OFFLINE_BF16])
def test_the_control_fails_the_cells_limit_on_the_card(cell, cuda):
    """The same at the cell's own size, on the card."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = harness.run_cell(cell, seed, 5.0, False, device=cuda,
                               control=True)
        assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("cell", [SERVE, OFFLINE, OFFLINE_BF16])
def test_the_control_is_one_precision_below_the_configuration(cell):
    r = config.resolve(cell)
    cfg, seed = config.shrink(r["config"]), 5
    params = traffic.model_weights(cfg, seed, "cpu")
    model, _ = harness.control_model(cfg, params,
                                     traffic.calib(cfg, seed, "cpu"),
                                     r["traffic"]["batch"], seed, "cpu")
    if cfg["precision"].get("quant") == "int8":
        assert isinstance(model, check.LowerReference)
        assert model.qmax == 7
    else:
        assert cfg["precision"]["dtype"] == "bfloat16"
        assert isinstance(model, CompiledCNN)
        assert model.spec.precision.quant == "int8"
