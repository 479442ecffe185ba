"""The port's twins of the paper's example drivers
(``src/repro_torch/examples/``), each through ``main(argv)`` at a small
size on the CPU, and the launcher's ``--trace-demo``.

The eclipse-orbit twin serves under the modeled clock, so its timeline
is data-independent: given the reference example's weights and requests
(carried over as numpy arrays), its per-phase dispatch counts, backend
mix, modeled energy and deferrals, its finish time and its envelope
ledger equal the reference example's printed ones line for line.
"""
import contextlib
import io
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import numpy as np
import torch

from repro.models import SPACE_MODELS as J_MODELS
from repro.models import synthetic_requests as j_requests
from repro_torch.convert import params_from_numpy
from repro_torch.examples import (eclipse_orbit, onboard_serving,
                                  qat_finetune, quickstart)
from repro_torch.launch import serve
from test_torch_support import to_numpy_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("model,trace", [
    ("logistic_net", False), ("logistic_net", True),
    ("vae_encoder", True), ("multi_esperta", True)])
def test_quickstart(model, trace, capsys):
    argv = ["--model", model, "--device", "cpu"] + (["--trace"] if trace
                                                    else [])
    assert quickstart.main(argv) == 0
    out = capsys.readouterr().out
    for line in ("[graph]", "[inspect]", "[plan]", "[run:accel]",
                 "[fidelity] flex vs cpu max|delta| = 0.00e+00",
                 "[modeled zcu104 dpu accel]"):
        assert line in out, line
    assert ("[trace] rebuilt" in out) == trace


@pytest.mark.parametrize("model,steps,batch", [("logistic_net", 3, 2),
                                               ("vae_encoder", 1, 2)])
def test_qat_finetune(model, steps, batch, capsys):
    argv = ["--model", model, "--steps", str(steps), "--batch", str(batch),
            "--device", "cpu"]
    assert qat_finetune.main(argv) == 0
    out = capsys.readouterr().out
    assert "[ptq] INT8 output error before QAT" in out
    assert f"after {steps} QAT steps" in out
    assert "[engine] accel outputs after QAT" in out


def test_qat_reduces_the_distillation_loss():
    """A few steps of distillation at logistic_net's width move the
    fake-quantized student toward the fp32 teacher on the same sample."""
    m = qat_finetune.SPACE_MODELS["logistic_net"]
    graph = m.build_graph()
    params = m.init_params(0)
    sample = m.synthetic_input(np.random.default_rng(0))
    teacher = {n: dict(p) for n, p in params.items()}
    losses = []
    for _ in range(4):
        params, loss, _ = qat_finetune.distill_step(graph, params, teacher,
                                                    sample, 0.1)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def _reference_orbit(n):
    """The reference example's printed output and the weights and
    requests it served, as numpy."""
    import runpy
    models = {}
    for mi, name in enumerate(eclipse_orbit.USE_CASES):
        m = J_MODELS[name]
        models[name] = (to_numpy_params(m.init_params(
            jax.random.PRNGKey(0))), j_requests(m, n, seed=1 + mi))
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["eclipse_orbit.py", "--requests", str(n)]
    try:
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
            runpy.run_path(str(ROOT / "examples" / "eclipse_orbit.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    assert e.value.code == 0
    return buf.getvalue(), models


def _ledger_lines(out):
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("phase"))
    return ([ln for ln in lines if ln.startswith("[orbit]")]
            + lines[start:start + 6]
            + [ln for ln in lines if ln.startswith(("[envelope]",
                                                    "[invariants]"))])


def test_eclipse_orbit_ledger_equals_the_references(capsys):
    n = 24
    ref_out, models = _reference_orbit(n)
    facts = eclipse_orbit.run_orbit(n, "cpu", models={
        name: (params_from_numpy(p, "cpu"), reqs)
        for name, (p, reqs) in models.items()})
    out = capsys.readouterr().out
    assert facts["ok"] and facts["served"] == 2 * n
    assert _ledger_lines(out) == _ledger_lines(ref_out)
    assert len(facts["rows"]) == len(eclipse_orbit.PHASES)


def test_eclipse_orbit_main(capsys):
    assert eclipse_orbit.main(["--requests", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 32/32 exactly once; envelope violations=0" in out


@pytest.mark.parametrize("backend", ["flex", "accel"])
def test_onboard_serving(backend, capsys):
    argv = ["--requests", "4", "--batch", "4", "--backend", backend,
            "--device", "cpu"]
    assert onboard_serving.main(argv) == 0
    out = capsys.readouterr().out
    assert "[baseline_net] 4/4 served" in out
    assert "[vae_encoder] 4/4 served" in out
    assert "[vae_encoder] downlink: raw=1.57 MB -> sent=0.0001 MB" in out
    assert "downlink reduction" in out


def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, qat_finetune.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--model", "logistic_net"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eclipse_orbit.main(["--requests", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onboard_serving.main(["--requests", "2"])


def test_trace_demo_serves_on_the_cpu(capsys):
    argv = ["--trace-demo", "--backend", "accel,flex", "--requests", "8",
            "--batch", "4", "--autotune", "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[trace-demo] 8/8 served" in out
    assert "[cloud_mask_cnn] 8/8 served" in out


def test_trace_demo_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--trace-demo", "--requests", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--trace-demo", "--backend", "dpu", "--device", "cpu"])
