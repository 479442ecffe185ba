"""The benchmark's manifest and its files, on the CPU: names and units in
the allowed characters, every cell, configuration and metric found by
name, the reference's layers equal to the program's graph, the operation
counts equal to the graph's, and no forbidden import anywhere under
``bench/``."""
import ast
import json
import re
import shutil
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


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A cell, a traffic mix and a configuration added as files and
    manifest entries are found by name, with no file edited."""
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
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = harness.Manifest(tmp_path)
    w = m.workload("vae.stream1200")
    assert m.traffic(w["traffic"])["rate_hz"] == 1200
    assert m.config(w["config"])["name"] == "vae_encoder_b"
    # metrics with no list of cells are the new cell's too
    assert {x["name"] for x in m.metrics("vae.stream1200", "end_to_end")} \
        == {"setup_s", "latency_p95_ms"}


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_reference_layers_are_the_programs(config):
    from repro_torch.models import SPACE_MODELS
    m = harness.Manifest()
    cfg = m.config(config)
    ref = harness.reference(config)
    graph = SPACE_MODELS[cfg["model"]].build_graph(**cfg["build_args"])
    harness.check_shapes(graph, ref.param_shapes(cfg))
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
