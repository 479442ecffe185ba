"""The port's model registry and CNetPlusScalar at its full published
width (256x256x2 image, channels 48/48/32, dense 92) against the JAX
reference: graph identity, and the accel plan's text given one JAX
calibration sample carried over."""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import numpy as np
import torch

from repro.core.engine import Engine as JEngine
from repro.models import SPACE_MODELS as J_MODELS
from repro.models import cnet_plus_scalar as jcnet
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.models import SPACE_MODELS as T_MODELS
from repro_torch.models import cnet_plus_scalar as tcnet
from repro_torch.models import synthetic_requests
from test_torch_support import graph_signature, to_numpy_params


@pytest.mark.parametrize("dpu_compatible", [True, False])
def test_cnet_graph_identity_full_width(dpu_compatible):
    j = jcnet.build_graph(dpu_compatible)
    t = tcnet.build_graph(dpu_compatible)
    assert graph_signature(t) == graph_signature(j)
    assert t.n_params == 3_050_485 and t.n_macs == j.n_macs
    assert t.summary() == j.summary()


def test_registry_mirrors_reference():
    for name, m in T_MODELS.items():
        jm = J_MODELS[name]
        assert (m.paper_params, m.paper_ops, m.paper_toolchain) == (
            jm.paper_params, jm.paper_ops, jm.paper_toolchain)
        assert graph_signature(m.build_graph()) == graph_signature(
            jm.build_graph())


def test_init_params_layout_and_scale():
    """Same shapes and dtypes as the reference's params (HWIO conv,
    [K, N] dense), He/LeCun scale, zero biases, deterministic per seed."""
    tp = tcnet.init_params(1)
    jp = jcnet.init_params(jax.random.PRNGKey(1))
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in tp.items()} == {
        n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jp.items()}
    for n, p in tp.items():
        assert p["w"].dtype == torch.float32
        assert float(p["b"].abs().max()) == 0.0
        fan_in = int(np.prod(p["w"].shape[:-1]))
        gain = 2.0 if n.startswith("conv") else 1.0
        assert float(p["w"].std()) == pytest.approx((gain / fan_in) ** 0.5,
                                                    rel=0.1)
    again = tcnet.init_params(1)
    assert all(torch.equal(tp[n]["w"], again[n]["w"]) for n in tp)
    assert not torch.equal(tcnet.init_params(2)["fc1"]["w"], tp["fc1"]["w"])


def test_synthetic_requests():
    reqs = synthetic_requests(T_MODELS["cnet_plus_scalar"], 3, seed=0)
    assert len(reqs) == 3
    for r in reqs:
        assert r["image"].shape == (256, 256, 2)
        assert r["image"].dtype == np.float32
        assert r["background_flux"].shape == (1,)
        assert np.isfinite(r["image"]).all()
    again = synthetic_requests(T_MODELS["cnet_plus_scalar"], 3, seed=0)
    assert all(np.array_equal(a["image"], b["image"])
               for a, b in zip(reqs, again))
    assert not np.array_equal(reqs[0]["image"], reqs[1]["image"])
    batch = tcnet.synthetic_batch(np.random.default_rng(0), 2)
    assert batch["image"].shape == (2, 256, 256, 2)


def test_accel_plan_text_identity_full_width():
    """One JAX calibration sample at full width, carried over: the port
    folds the identical accel plan (fusion groups, requant chains, scales,
    arena) and quantizes the weights bit-identically."""
    jg = jcnet.build_graph()
    jp = jcnet.init_params(jax.random.PRNGKey(1))
    sample = synthetic_requests(T_MODELS["cnet_plus_scalar"], 1, seed=0)
    je = JEngine(jg, jp)
    je.calibrate(sample)
    te = TEngine(tcnet.build_graph(),
                 params_from_numpy(to_numpy_params(jp), "cpu"), device="cpu")
    te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err, "cpu"))
    jtext = je.planned("accel").as_text()
    assert te.planned("accel").as_text() == jtext
    assert "5 quantized node(s)" in jtext
    for name, q in je._quant.items():
        np.testing.assert_array_equal(te._quant[name].w_q.numpy(),
                                      np.asarray(q.w_q))
        np.testing.assert_array_equal(te._quant[name].w_scale.numpy(),
                                      np.asarray(q.w_scale))
