"""The served seed chain against the JAX reference: the narrow VAE encoder
(its published channels at a 32x64x3 input, the reference's params and
calibration carried over) served on ``accel``.

* ``split_seeds`` is ``jax.random.split`` on raw keys;
* a service's chain starts at the raw data of ``PRNGKey(u32(name[:4]))``;
* through ``ServingPipeline.run`` (fixed batches, the chain from key
  (0, 0)) and a modeled-clock ``serve_trace`` (one key a dispatch, split
  into one per sample), every request's ``sample`` is within 2e-6
  relative (atol 1e-6) of the reference's: the threefry bits are exact,
  ``log1p`` and ``exp`` may differ by an ulp (``kernels/sample.py``).
  ``mu`` and ``logvar`` are bit-exact (an int8 chain from the input);
* after the trace, ``state_dict()["rng"]`` equals the reference's.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import numpy as np

from repro.core.engine import Engine as JEngine
from repro.core.opgraph import Graph as JGraph
from repro.core.pipeline import ServingPipeline as JPipeline
from repro.core.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.models.common import init_graph_params as j_init
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.pipeline import ServingPipeline as TPipeline
from repro_torch.core.pipeline import split_seeds
from repro_torch.core.scheduler import ContinuousBatchingScheduler as TScheduler
from repro_torch.core.scheduler import poisson_arrivals
from repro_torch.models import vae_encoder as tvae
from test_torch_space_models import vae_like
from test_torch_support import to_numpy_params

VAE_NARROW = (32, 64, 3)
SAMPLE_TOL = dict(rtol=2e-6, atol=1e-6)
N_REQUESTS = 10
NAME = "vae_encoder"


@pytest.fixture(scope="module")
def engines():
    jg, tg = vae_like(JGraph, VAE_NARROW), tvae.build_graph(VAE_NARROW)
    jp = j_init(jg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    calib = [tvae.synthetic_input(rng, VAE_NARROW) for _ in range(4)]
    je = JEngine(jg, jp)
    je.calibrate(calib)
    te = TEngine(tg, params_from_numpy(to_numpy_params(jp), "cpu"),
                 device="cpu")
    te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                               "cpu"))
    reqs = [tvae.synthetic_input(rng, VAE_NARROW) for _ in range(N_REQUESTS)]
    return je, te, reqs


def _recorder():
    """A keep predicate that records every served sample's outputs."""
    seen = []

    def keep(out):
        seen.append({k: np.array(v) for k, v in out.items()})
        return True
    return keep, seen


def _held(t_outs, j_outs):
    assert len(t_outs) == len(j_outs) == N_REQUESTS
    for t, j in zip(t_outs, j_outs):
        np.testing.assert_array_equal(t["mu"], j["mu"])
        np.testing.assert_array_equal(t["logvar"], j["logvar"])
        np.testing.assert_allclose(t["sample"], j["sample"], **SAMPLE_TOL)


@pytest.mark.parametrize("raw", [(0, 0), (0, 0x5F656176), (7, 0),
                                 (0xFFFFFFFF, 123456789)])
def test_split_seeds_is_the_threefry_split(raw):
    key = jax.random.wrap_key_data(np.array(raw, np.uint32))
    want = np.asarray(jax.random.key_data(jax.random.split(key, 5)))
    got = split_seeds(np.array(raw, np.uint32), 5)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_service_chain_starts_at_the_references_key(engines):
    je, te, reqs = engines
    js, ts = JScheduler(clock="modeled"), TScheduler(clock="modeled")
    js.register(NAME, je, backend="accel", ladder=(1,))
    ts.register(NAME, te, backend="accel", ladder=(1,))
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(
        int(np.frombuffer(b"vae_", np.uint32)[0]))))
    np.testing.assert_array_equal(ts.state_dict()["models"][NAME]["rng"],
                                  want)
    np.testing.assert_array_equal(js.state_dict()["models"][NAME]["rng"],
                                  want)


def test_pipeline_run_samples_match_reference(engines):
    je, te, reqs = engines
    jk, j_outs = _recorder()
    tk, t_outs = _recorder()
    JPipeline(je, "accel", batch_size=4, keep_predicate=jk).run(reqs)
    TPipeline(te, "accel", batch_size=4, keep_predicate=tk).run(reqs)
    _held(t_outs, j_outs)


def test_serve_trace_samples_and_rng_match_reference(engines):
    je, te, reqs = engines
    arrivals = poisson_arrivals(400.0, N_REQUESTS, seed=5)
    trace = [(t, NAME, r) for t, r in zip(arrivals, reqs)]
    sides = []
    for sched_cls, engine in ((JScheduler, je), (TScheduler, te)):
        sched = sched_cls(clock="modeled")
        sched.register(NAME, engine, backend="accel", ladder=(1, 2, 4))
        sched.serve_trace(trace)
        comps = sorted(sched.completions, key=lambda c: c.rid)
        sides.append((sched, [c.outputs for c in comps],
                      [(d.rung, d.n_real) for d in sched.dispatches]))
    (js, j_outs, j_disp), (ts, t_outs, t_disp) = sides
    assert t_disp == j_disp and len(t_disp) > 1
    _held(t_outs, j_outs)
    np.testing.assert_array_equal(ts.state_dict()["models"][NAME]["rng"],
                                  js.state_dict()["models"][NAME]["rng"])
