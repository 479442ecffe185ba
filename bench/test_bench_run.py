"""Whole runs of the harness without the card: the program's plain
kernels on the CPU at small widths (``control.NARROW``), a stand-in for
the card's energy counter, short windows. A sound run comes out correct;
a run whose timed path is broken underneath (an answer altered where it
is produced; half of a batch left out, the mean of the rest in its place)
comes out not correct; and the control, the reference in int4, fails the
configuration's limits. On the card (``-m gpu``) the control is read at
the cells' own sizes.
"""
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from bench import control, harness
from bench import run as bench_run

ROOT = Path(__file__).resolve().parent.parent


class StandInEnergy:
    """100 W, by the host clock: the CPU has no energy counter."""
    name = "stand_in"

    def begin(self):
        self.t = time.monotonic()

    def end(self):
        return 100.0 * (time.monotonic() - self.t)

    def power_limit_w(self):
        return None

    def close(self):
        pass


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_rate(traffic):
    """An open-loop rate the CPU keeps up with at the narrow widths: 40
    frames a second for single frames, ten full batches a second."""
    return {"rate_hz": 40.0 if traffic["ladder"][-1] == 1
            else 10.0 * traffic["ladder"][-1]}


def run_cpu(cell, seed, seconds=0.5, trace=False):
    m = harness.Manifest()
    w = m.workload(cell)
    return bench_run.run_cell(m, w, seed, seconds, trace, device="cpu",
                              t_start=time.monotonic(),
                              energy_source=StandInEnergy(),
                              overrides=control.NARROW[w["config"]],
                              traffic_overrides=cpu_rate(
                                  m.traffic(w["traffic"])))


@pytest.mark.parametrize("cell,seed", [("cnet.stream", 2 ** 31 + 17),
                                       ("vae.stream", 5),
                                       ("cnet.cadence", 6)])
def test_sound_run_is_correct(one_thread, cell, seed):
    r = run_cpu(cell, seed)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"
    assert r["attempted"] > 0
    assert r["check"]["answers_missing"]["value"] == 0
    assert "setup_s" in r["metrics"]


def test_closed_loop_mix_runs_from_data_alone(one_thread, tmp_path):
    """The closed loop (``traffic/backlog64.json``, no cell yet): a cell
    added as a manifest entry over it runs correct, answers are attempted
    inside the window, and its ragged tail is checked with the rest."""
    for sub in ("configs", "traffic", "reference", "systems"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "vae.backlog", "config": "vae_encoder",
                              "traffic": "backlog64", "chips": 1,
                              "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = harness.Manifest(tmp_path)
    w = m.workload("vae.backlog")
    r = bench_run.run_cell(m, w, 2 ** 31 + 3, 0.5, False, device="cpu",
                           t_start=time.monotonic(),
                           energy_source=StandInEnergy(),
                           overrides=control.NARROW[w["config"]])
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["check"]["answers_missing"]["value"] == 0


def test_traced_run_reports_its_window(one_thread):
    r = run_cpu("vae.cadence", 8, seconds=1.0, trace=True)
    assert r["correct"], r["check"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["metrics"]) == {"sched_wait_ms.cadence", "retire_ms.cadence",
                                 "latency_p95_ms.cadence"}


def _break_output(monkeypatch, how):
    from repro_torch.core import plan as plan_mod
    orig = plan_mod.CompiledPlan.__call__

    def broken(self, inputs, rngs):
        out = orig(self, inputs, rngs)
        name = next(iter(out))
        y = out[name].clone()
        if how == "altered":
            y[0] = y[0] + 0.5 * (y.abs().max() + 1.0)
        else:
            half = y.shape[0] // 2
            y[half:] = y[:half].mean(dim=0)
        out[name] = y
        return out

    monkeypatch.setattr(plan_mod.CompiledPlan, "__call__", broken)


@pytest.mark.parametrize("how", ["altered", "half_batch"])
@pytest.mark.parametrize("cell", ["cnet.stream", "vae.stream"])
def test_broken_timed_path_is_not_correct(one_thread, monkeypatch, cell,
                                          how):
    _break_output(monkeypatch, how)
    r = run_cpu(cell, 9)
    assert not r["correct"], r["check"]


def test_answer_altered_at_b1_is_not_correct(one_thread, monkeypatch):
    _break_output(monkeypatch, "altered")
    assert not run_cpu("cnet.cadence", 10)["correct"]


@pytest.mark.parametrize("cell", ["cnet.stream", "vae.stream"])
def test_control_fails_the_limits(one_thread, cell):
    """The reference in int4 in the program's place: at least one number
    passes its limit, on three seeds."""
    m = harness.Manifest()
    w = m.workload(cell)
    limits = m.config(w["config"])["check"]["limits"]
    for seed in (1, 2, 3):
        prog, ctl, n = control.readings(
            m, w, seed, 0.3, torch.device("cpu"),
            control.NARROW[w["config"]], cpu_rate(m.traffic(w["traffic"])))
        assert n > 0
        assert all(prog[f"{k}_gap"] <= v for k, v in limits.items()), prog
        assert any(ctl[f"{k}_gap"] > v for k, v in limits.items()), ctl


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "cnet.stream", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_when_jax_is_loaded(monkeypatch, capsys):
    """The process that prints the result refuses one with JAX loaded."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench_run, "run_cell", lambda *a, **k: {"check": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = bench_run.main(["--workload", "cnet.stream", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and bench/ has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "cnet.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cnet.stream", "vae.stream"])
def test_control_fails_the_limits_on_the_card(card, cell):
    m = harness.Manifest()
    w = m.workload(cell)
    limits = m.config(w["config"])["check"]["limits"]
    for seed in (101, 102, 103):
        prog, ctl, n = control.readings(m, w, seed, 2.0, card)
        assert n >= 100
        assert all(prog[f"{k}_gap"] <= v for k, v in limits.items()), prog
        assert any(ctl[f"{k}_gap"] > v for k, v in limits.items()), ctl
