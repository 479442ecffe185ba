"""The served systems, on the CPU: every configuration names a system
module that exists; the space system's weights and frames are what they
were before the system had a module of its own, bit for bit; and the
space system takes 3-D convolution networks (the program's
``baseline_net`` graph): its shape check, its He-normal init and the
references' SAME conv3d."""
import hashlib
import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from bench import harness
from bench.reference import common

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in MANIFEST["configs"]]


def space():
    return harness.system({"system": "space"})


@pytest.mark.parametrize("config", CONFIGS)
def test_every_configuration_names_a_system(config):
    cfg = harness.Manifest().config(config)
    assert (ROOT / "bench" / "systems" / f"{cfg['system']}.py").is_file()
    mod = harness.system(cfg)
    for fn in ("build", "compare", "control"):
        assert callable(getattr(mod, fn)), fn


def _digest(inputs) -> str:
    h = hashlib.sha256()
    for node in sorted(inputs.params):
        for part in sorted(inputs.params[node]):
            h.update(inputs.params[node][part].contiguous().numpy().tobytes())
    for group in (inputs.calib, inputs.pool):
        for k in sorted(group):
            h.update(group[k].contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 of the weights, calibration frames and pool frames that the
# harness made on the CPU before the space system moved into its module
@pytest.mark.parametrize("config,seed,digest", [
    ("cnet_plus_scalar", 2 ** 33 + 5, "11eba03c2c93269a"),
    ("cnet_plus_scalar", 7, "478d15d50b8335d7"),
    ("vae_encoder", 2 ** 33 + 5, "0260af4e096a00e3"),
    ("vae_encoder", 7, "5536cb91ff952b88"),
])
def test_inputs_are_pinned_bit_for_bit(config, seed, digest):
    cfg = harness.Manifest().config(config)
    cfg.update(pool_frames=3, calibration_frames=2)
    inputs = space().make_inputs(cfg, harness.reference(config), seed, "cpu")
    assert _digest(inputs) == digest


BASELINE_SHAPES = {
    "conv0": {"w": (3, 3, 3, 1, 16), "b": (16,)},
    "conv1": {"w": (3, 3, 3, 16, 48), "b": (48,)},
    "fc1": {"w": (8 * 4 * 8 * 48, 73), "b": (73,)},
    "head": {"w": (73, 4), "b": (4,)},
}


def test_check_shapes_takes_a_conv3d_graph():
    from repro_torch.models.mms import build_baseline_graph
    sp = space()
    graph = build_baseline_graph()
    sp.check_shapes(graph, BASELINE_SHAPES)
    wrong = dict(BASELINE_SHAPES, conv1={"w": (3, 3, 16, 48), "b": (48,)})
    with pytest.raises(ValueError):
        sp.check_shapes(graph, wrong)


def test_make_params_gives_every_conv_he_std():
    shapes = dict(BASELINE_SHAPES, conv2d={"w": (3, 3, 16, 48), "b": (48,)})
    params = space().make_params(shapes, 2 ** 31 + 9, "cpu", 0.05)
    for node, sh in shapes.items():
        w = params[node]["w"]
        assert tuple(w.shape) == sh["w"]
        gain = 2.0 if w.ndim in (4, 5) else 1.0
        fan_in = math.prod(sh["w"][:-1])
        assert float(w.std()) == pytest.approx(math.sqrt(gain / fan_in),
                                               rel=0.1), node


@pytest.mark.parametrize("kernel", [(3, 3, 3), (2, 3, 4)])
def test_apply_runs_5d_weights_as_same_conv3d(kernel):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 6, 7, 3, generator=g, dtype=torch.float64)
    w = torch.randn(*kernel, 3, 4, generator=g, dtype=torch.float64)
    got = common._apply(w, x, 1)
    want = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                    padding="same").permute(0, 2, 3, 4, 1)
    assert got.shape == (2, 5, 6, 7, 4)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_a_conv3d_layer_quantizes():
    """PTQ over a DHWIO weight: per-output-channel codes, the calibrated
    int8 layer near its fp32 output, the int4 control farther off."""
    g = torch.Generator().manual_seed(4)
    params = {"c": {"w": torch.randn(3, 3, 3, 2, 5, generator=g) * 0.2,
                    "b": torch.randn(5, generator=g) * 0.05}}
    calib = {"x": torch.randn(2, 4, 6, 6, 2, generator=g)}

    def forward(p, batch, layer, keys=None):
        return {"y": layer("c", batch["x"])}

    x = calib["x"][1:]
    want = common._apply(params["c"]["w"], x, 1) + params["c"]["b"]
    top = float(want.abs().max())
    errs = {}
    for bits in (8, 4):
        qs = common.calibrate(forward, params, calib, bits, 1.0)
        assert qs.codes["c"][0].shape == (3, 3, 3, 2, 5)
        errs[bits] = float((qs.serving("c", x) - want).abs().max()) / top
    assert errs[8] < 0.05 < errs[4]
