"""The benchmark's manifest and its files, on the CPU: names and units in
the allowed characters, every cell, configuration and metric found by
name, the reference's layers equal to the program's graph, the operation
counts equal to the graph's, and no forbidden import anywhere under
``bench/``."""
import ast
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["paths"] == ["bench"]
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                               "source"} | extra
    all_names = (names + [w["name"] for w in MANIFEST["workloads"]]
                 + [m["name"] for k in ("end_to_end", "per_layer")
                    for m in MANIFEST[k]])
    assert all(NAME.match(n) for n in all_names)
    assert len(set(names)) == len(names)


def test_every_cell_reports_what_the_contract_asks():
    m = harness.Manifest()
    e2e = {x["name"] for x in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for w in MANIFEST["workloads"]:
        ends = {x["name"] for x in m.metrics(w["name"], "end_to_end")}
        layers = m.metrics(w["name"], "per_layer")
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        assert layers, w["name"]
        for x in layers:
            assert x["moves"] in ends, (w["name"], x["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_by_name(cell):
    m = harness.Manifest()
    w = m.workload(cell)
    cfg = m.config(w["config"])
    traffic = m.traffic(w["traffic"])
    ref = harness.reference(w["config"])
    assert cfg["name"] == w["config"]
    assert traffic["loop"] in harness.LOOPS
    assert set(cfg["check"]["limits"]) == set(ref.OUTPUTS)
    for kind in ("end_to_end", "per_layer"):
        for x in m.metrics(cell, kind):
            assert callable(harness.metric_reader(x["name"]).read)
    for layer in ref.layers(cfg):
        c = harness.counts(layer["op"])
        assert c.ops(layer, 2) >= c.mac_ops(layer, 2) >= 0


ECHO_SYSTEM = '''"""A served system that answers each request with its frame index."""
import time

import numpy as np

from bench import devtrace, harness


class Echo:
    def __init__(self, cfg):
        self.n_pool = cfg["pool_frames"]
        self.deadline_s = cfg["deadline_s"]
        self.reqs, self.answers, self.on_answers = {}, {}, None
        self.served = []

    def submit(self, k, due, tail=False):
        req = harness.Req(len(self.reqs), k % self.n_pool, due,
                          time.monotonic(), tail=tail)
        self.reqs[req.rid] = req
        self.serve(req)
        return req

    def serve(self, req):
        self.answers[req.rid] = {"echo": np.array([float(req.frame)])}
        self.served.append(req)
        req.answered = time.monotonic()
        if self.on_answers is not None:
            self.on_answers(1, req.answered)

    def start(self):
        pass

    def stop(self):
        pass

    def outputs(self):
        return self.answers

    def release(self):
        pass

    def trace_hooks(self):
        return devtrace.Hooks(step=(self, "serve"), step_label="echo.serve",
                              on_thread=lambda: True, spans=[],
                              dispatches=lambda: self.served)


def build(cfg, ref, traffic, seed, device):
    return Echo(cfg)


def compare(cfg, ref, seed, device, reqs, outputs):
    missing = sum(1 for r in reqs if r.rid not in outputs)
    wrong = sum(1 for r in reqs if r.rid in outputs
                and outputs[r.rid]["echo"][0] != r.frame)
    return {"answers_missing": [missing, 0], "echo_wrong": [wrong, 0]}, set()


def control(cfg, ref, seed, device, picked):
    return {"echo_wrong": len(picked)}
'''


def _add_echo_cell(root: Path, data) -> None:
    """The files and manifest entries of a new system, its configuration,
    its reference and its cell, written under ``root``."""
    bench = root / "bench"
    for sub in ("systems", "reference", "configs", "traffic"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    (bench / "systems" / "echo.py").write_text(ECHO_SYSTEM)
    (bench / "reference" / "echo.py").write_text(
        'OUTPUTS = ("echo",)\n\n\ndef layers(cfg):\n    return []\n')
    (bench / "configs" / "echo.json").write_text(json.dumps(
        {"name": "echo", "system": "echo", "pool_frames": 8,
         "deadline_s": 0.5}))
    (bench / "traffic" / "echo_open.json").write_text(json.dumps(
        {"loop": "open", "rate_hz": 200, "ladder": [1],
         "trace_seconds": 0.2}))
    data["configs"].append({"name": "echo", "source": "a test system",
                            "file": "bench/configs/echo.json",
                            "reduced": [], "why": "a test system"})
    data["workloads"].append({"name": "echo.open", "config": "echo",
                              "traffic": "echo_open", "chips": 1,
                              "why": "a test cell"})


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A cell, a traffic mix and a configuration added as files and
    manifest entries are found by name, with no file edited; so is a new
    served system, which runs its cell end to end."""
    from bench import run as bench_run
    shutil.copytree(BENCH / "configs", tmp_path / "bench" / "configs")
    shutil.copytree(BENCH / "traffic", tmp_path / "bench" / "traffic")
    data = json.loads(json.dumps(MANIFEST))
    new_traffic = dict(json.loads(
        (BENCH / "traffic" / "stream_vae.json").read_text()), rate_hz=1200)
    (tmp_path / "bench" / "traffic" / "stream1200.json").write_text(
        json.dumps(new_traffic))
    cfg = json.loads((BENCH / "configs" / "vae_encoder.json").read_text())
    cfg["name"] = "vae_encoder_b"
    (tmp_path / "bench" / "configs" / "vae_encoder_b.json").write_text(
        json.dumps(cfg))
    data["configs"].append(dict(data["configs"][1], name="vae_encoder_b",
                                file="bench/configs/vae_encoder_b.json"))
    data["workloads"].append({"name": "vae.stream1200",
                              "config": "vae_encoder_b",
                              "traffic": "stream1200", "chips": 1,
                              "why": "a test cell"})
    # a new cell joins the list of cells of a metric it reports
    p95 = next(x for x in data["end_to_end"] if x["name"] == "latency_p95_ms")
    p95["workloads"] += ["vae.stream1200", "echo.open"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = harness.Manifest(tmp_path)
    w = m.workload("vae.stream1200")
    assert m.traffic(w["traffic"])["rate_hz"] == 1200
    assert m.config(w["config"])["name"] == "vae_encoder_b"
    # metrics with no list of cells are the new cell's too
    assert {x["name"] for x in m.metrics("vae.stream1200", "end_to_end")} \
        == {"setup_s", "latency_p95_ms"}

    _add_echo_cell(tmp_path, data)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = harness.Manifest(tmp_path)
    r = bench_run.run_cell(m, m.workload("echo.open"), 2 ** 31 + 21, 0.3,
                           False, device="cpu", t_start=time.monotonic())
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["check"]) == {"answers_missing", "echo_wrong"}
    assert set(r["metrics"]) == {"setup_s", "latency_p95_ms"}


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_reference_layers_are_the_programs(config):
    from repro_torch.models import SPACE_MODELS
    m = harness.Manifest()
    cfg = m.config(config)
    ref = harness.reference(config)
    graph = SPACE_MODELS[cfg["model"]].build_graph(**cfg["build_args"])
    harness.system(cfg).check_shapes(graph, ref.param_shapes(cfg))
    layers = ref.layers(cfg)
    ops = sum(harness.counts(x["op"]).ops(x, 1) for x in layers)
    macs = sum(harness.counts(x["op"]).mac_ops(x, 1) for x in layers)
    assert macs == 2 * graph.n_macs
    # the graph counts the same epilogue terms (bias, relu, pool, sample)
    epilogue = ops - macs
    assert abs(ops - graph.n_ops) <= epilogue
    assert ops == graph.n_ops


def test_counts_match_chip_smoke_bounds():
    """CNet's three int8 convs at B=16: chip_smoke's summed bound,
    0.0266 ms, each bound by its bytes."""
    m = harness.Manifest()
    cfg = m.config("cnet_plus_scalar")
    c = harness.counts("conv2d")
    total = 0.0
    for layer in harness.reference("cnet_plus_scalar").layers(cfg):
        if layer["op"] != "conv2d":
            continue
        t_bytes = c.nbytes(layer, 16) / 3.35e12 * 1e3
        assert t_bytes > c.mac_ops(layer, 16) / 1.979e15 * 1e3
        total += t_bytes
    assert total == pytest.approx(0.0266, abs=5e-5)
    fc1 = dict(op="dense", precision="int8", k_in=32769, n=92,
               out_int8=True)
    d = harness.counts("dense")
    assert d.nbytes(fc1, 16) == 16 * 32769 + 32769 * 92 + 4 * (16 + 184) \
        + 16 * 92


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    found = set(_imports(path))
    assert not found & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if path.parent.name == "reference":
        assert "repro_torch" not in found


def test_harness_finds_every_handwritten_family():
    fams = harness.handwritten_kernels()
    names = {f["family"] for f in fams}
    assert {"conv2d_int8", "int8_matmul", "quantize_apply",
            "sample_normal"} <= names
    for f in fams:
        assert f["match"] and f["layer_op"] and f["precision"]
