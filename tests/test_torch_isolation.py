"""Isolation guards for the PyTorch port.

* ``import repro_torch`` (every submodule) never loads ``jax``;
* nothing in ``src/repro_torch`` or ``chip_smoke.py`` imports the JAX
  package ``repro``;
* the six numpy-only modules the port copies, and the front-end's
  ``frontend/ir.py``, equal their originals after the ``repro.`` ->
  ``repro_torch.`` rewrite, so any drift is deliberate;
* entry points need a card unless the caller asks for the CPU, and
  ``chip_smoke.py`` fails (printing no verdict) without one;
* the launcher accepts only the flags the ported slices support, and
  serves fault storms, orbit radiation storms (ECC/TMR protection) and
  checkpoint/restore on the CPU.
"""
import ast
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core.engine import Engine
from repro_torch.launch import serve
from repro_torch.models import cnet_plus_scalar as tcnet

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
COPIED = ("opgraph", "inspector", "passes", "memory", "energy",
          "radiation")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


LM_SLICE = ("repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd",
            "repro_torch.core.lm_quant", "repro_torch.core.lm",
            "repro_torch.models.lm")
FRONTEND_SLICE = ("repro_torch.frontend", "repro_torch.frontend.ir",
                  "repro_torch.frontend.ops", "repro_torch.frontend.trace",
                  "repro_torch.frontend.translators",
                  "repro_torch.frontend.demo", "repro_torch.core.quantize",
                  "repro_torch.examples.quickstart",
                  "repro_torch.examples.qat_finetune",
                  "repro_torch.examples.eclipse_orbit",
                  "repro_torch.examples.onboard_serving")


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.scheduler" in mods and len(mods) >= 25
    assert set(LM_SLICE) <= set(mods)
    assert set(FRONTEND_SLICE) <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), (path, name)


@pytest.mark.parametrize("name", COPIED)
def test_copied_modules_equal_their_originals(name):
    orig = (ROOT / "src" / "repro" / "core" / f"{name}.py").read_text()
    port = (PORT / "core" / f"{name}.py").read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", orig)


@pytest.mark.parametrize("mod", FRONTEND_SLICE)
def test_the_frontend_qat_and_examples_alone_load_no_jax(mod):
    """Each module of the front-end/QAT/examples slice imported on its
    own, in a fresh process, loads neither jax nor repro."""
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_frontend_ir_equals_its_original():
    orig = (ROOT / "src" / "repro" / "frontend" / "ir.py").read_text()
    port = (PORT / "frontend" / "ir.py").read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", orig)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tcnet.build_graph(input_shape=(8, 8, 2), channels=(2, 2, 2),
                          dense=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(g, tcnet.init_params(0, input_shape=(8, 8, 2),
                                    channels=(2, 2, 2), dense=3))
    e = Engine(g, tcnet.init_params(0, input_shape=(8, 8, 2),
                                    channels=(2, 2, 2), dense=3),
               device="cpu")
    assert e.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("flag", [
    ["--lm-legacy"], ["--prompt-len", "8"], ["--arch", "tinyllama-1.1b"],
    ["--kv8"], ["--w8"]])
def test_launcher_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parser().parse_args(flag)
    assert e.value.code == 2


def test_lm_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parser().parse_args(["--mode", "lm", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_lm_scheduler(args)
    args = serve.parser().parse_args(["--mode", "lm", "--requests", "1",
                                      "--device", "cpu", "--backend", "dpu"])
    with pytest.raises(SystemExit):
        serve.build_lm_scheduler(args)


def test_launcher_rejects_bad_lists_and_envelope_flags():
    for argv in (["--model", "no_such_model"], ["--backend", "dpu"],
                 ["--burst-j", "1", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            serve.build_scheduler(serve.parser().parse_args(argv))


def test_launcher_serves_the_slice_on_the_cpu(capsys):
    """The slice's command at full width, on the CPU plain versions, with
    a small request count."""
    assert serve.main(["--mode", "space", "--model", "cnet_plus_scalar",
                       "--backend", "accel", "--requests", "3", "--batch",
                       "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3/3 served" in out and "backends[accel:" in out


FAULT_CMD = ["--mode", "space", "--model", "logistic_net", "--backend",
             "accel,cpu", "--device", "cpu", "--clock", "modeled",
             "--requests", "24", "--batch", "4", "--rate", "400"]


def _fault_line(out):
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("[faults] injected=")]
    return {k: v for k, v in (f.split("=") for f in line.split()
                              if "=" in f)}


@pytest.mark.parametrize("flags,want", [
    (["--fault-rate", "60", "--self-test-period", "0.01"], "all"),
    (["--fault-rate", "60", "--self-test-period", "0.01", "--recovery",
      "demote", "--fault-seed", "2"], "all"),
    (["--radiation", "orbit", "--base-upset-rate", "100", "--fault-seed",
      "1"], "all"),
    (["--radiation", "orbit", "--base-upset-rate", "100", "--fault-seed",
      "1", "--protection", "ecc"], "all"),
    (["--radiation", "orbit", "--base-upset-rate", "100", "--fault-seed",
      "1", "--protection", "tmr", "--checkpoint-cadence", "auto"], "all")],
    ids=["poisson", "demote", "orbit", "orbit-ecc", "orbit-tmr"])
def test_launcher_serves_fault_storms_on_the_cpu(flags, want, capsys):
    """The fault and radiation flags through the launcher at full width
    on the CPU plain versions: upsets land, every one is detected and
    recovered, and every request is served."""
    assert serve.main(FAULT_CMD + flags) == 0
    out = capsys.readouterr().out
    assert "24/24 served" in out and "[faults] armed 1 model(s)" in out
    rep = _fault_line(out)
    assert int(rep["injected"]) >= 1
    assert rep["detected"] == rep["recovered"] == rep["injected"]
    if "--radiation" in flags:
        assert "[radiation] orbit model: base=100/s" in out
    if "--checkpoint-cadence" in flags:
        assert "[radiation] checkpoint cadence: T*=" in out
    if "demote" in flags:
        assert "cpu:" in out.split("backends[")[1]


def test_launcher_checkpoint_saved_then_restored(tmp_path, capsys):
    """--checkpoint saves the ledger after serving; a second run (the
    reboot) restores it before serving and has nothing left to serve."""
    path = str(tmp_path / "ledger.npz")
    cmd = FAULT_CMD + ["--self-test-period", "0.02", "--checkpoint", path]
    assert serve.main(cmd) == 0
    out = capsys.readouterr().out
    assert f"[checkpoint] saved {path}" in out and "restored" not in out
    assert serve.main(cmd) == 0
    out = capsys.readouterr().out
    assert f"[checkpoint] restored {path}: 24 completed, 0 queued" in out
    assert "[serve] 0 requests" in out and f"[checkpoint] saved {path}" in out
