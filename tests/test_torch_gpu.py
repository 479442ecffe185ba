"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the engine and scheduler on the card against the same engine
on the CPU. Bit-exact throughout, except sigmoid (1e-6 relative: the
kernel's expf and PyTorch's sigmoid may differ by an ulp) and the fp32
flex path (1e-4: cuDNN and the CPU convolution sum in different orders).

Every test here needs a CUDA card and is marked ``gpu``; without a card
they skip. This file imports nothing of the JAX reference, so it runs on
the GPU machine:

    python -m pytest -m gpu tests/test_torch_*.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import ContinuousBatchingScheduler
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as tquant
from repro_torch.models import cnet_plus_scalar as tcnet

pytestmark = pytest.mark.gpu

NARROW = dict(input_shape=(32, 32, 2), channels=(8, 8, 4), dense=12)
REQUANT = 0.0123456789


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture
def cpu_engine():
    """A narrow CNet engine on the CPU, calibrated by the port itself."""
    g = tcnet.build_graph(**NARROW)
    e = Engine(g, tcnet.init_params(3, **NARROW), device="cpu")
    rng = np.random.default_rng(3)
    e.calibrate([tcnet.synthetic_input(rng, NARROW["input_shape"])
                 for _ in range(4)])
    return e


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [tcnet.synthetic_input(rng, NARROW["input_shape"])
            for _ in range(n)]


@pytest.mark.parametrize("m,k,n", [(1, 5, 3), (16, 32769, 92), (16, 92, 1),
                                   (33, 300, 130)])
@pytest.mark.parametrize("act,requant,bias", [
    (None, None, True), ("relu", REQUANT, True), ("sigmoid", None, False)])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, k, n, act, requant,
                                          bias):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g) if bias else None
    args = [v.to(cuda_device) if v is not None else None
            for v in (x, w, xs, ws, b)]
    before = tmm.launches
    got = tmm.int8_matmul(*args, act=act, requant_scale=requant)
    torch.cuda.synchronize()
    assert tmm.launches == before + 1
    want = tmm.int8_matmul_plain(*args, act, requant)
    if act == "sigmoid":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,cin,cout,stride,padding", [
    (2, 10, 9, 4, 3, 2, "VALID"), (3, 37, 70, 2, 48, 1, "SAME"),
    (2, 64, 64, 48, 32, 1, "SAME"), (1, 9, 11, 5, 7, 2, "SAME")])
@pytest.mark.parametrize("act,requant,bias", [
    (None, None, True), ("relu", 0.05, True), ("relu", None, False)])
def test_conv2d_int8_kernel_matches_plain(cuda_device, b, h, w, cin, cout,
                                          stride, padding, act, requant,
                                          bias):
    g = torch.Generator().manual_seed(b + h + w + cin + cout)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=g,
                      dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(cout, generator=g) * 0.01).to(cuda_device)
    bb = torch.randn(cout, generator=g).to(cuda_device) if bias else None
    kw = dict(x_scale=0.0377, stride=stride, padding=padding, act=act,
              requant_scale=requant)
    before = tconv.launches
    got = tconv.conv2d_int8(x, wq, ws, bb, **kw)
    torch.cuda.synchronize()
    assert tconv.launches == before + 1
    assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, bb, **kw))


@pytest.mark.parametrize("m,n", [(18, 48), (32769, 92), (92, 1)])
def test_quantize_apply_kernel_matches_plain(cuda_device, m, n):
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, n), generator=g).to(cuda_device)
    scale = x.abs().amax(0) / 127.0 + 1e-12
    before = tquant.launches
    got = tquant.quantize_apply(x, scale)
    torch.cuda.synchronize()
    assert tquant.launches == before + 1
    assert torch.equal(got, tquant.quantize_apply_plain(x, scale))


def test_card_engine_matches_cpu_engine(cuda_device, cpu_engine):
    batch = tcnet.synthetic_batch(np.random.default_rng(7), 6,
                                  NARROW["input_shape"])
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    kops.reset_launch_counts()
    got = card.run_batch(batch, "accel")["head"].cpu()
    assert kops.launch_counts() == {"int8_matmul": 2, "conv2d_int8": 3,
                                    "quantize_apply": 0}
    assert torch.equal(got, cpu_engine.run_batch(batch, "accel")["head"])
    torch.testing.assert_close(
        card.run_batch(batch, "flex")["head"].cpu(),
        cpu_engine.run_batch(batch, "flex")["head"], rtol=1e-4, atol=1e-4)
    card.calibrate([{k: v[i] for k, v in batch.items()} for i in range(2)])
    assert kops.launch_counts()["quantize_apply"] == 5


def test_card_scheduler_matches_cpu_outputs(cuda_device, cpu_engine):
    """Pipelined serving on the card (pinned staging slots, async copies)
    returns, per request, the CPU engine's bit-exact accel output."""
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    reqs = _requests(9, seed=21)
    s = ContinuousBatchingScheduler(pipeline=True)
    s.register("cnet_plus_scalar", card, backend="accel", ladder=(1, 4),
               warmup_sample=reqs[0])
    s.serve_trace([(0.0005 * i, "cnet_plus_scalar", r)
                   for i, r in enumerate(reqs)])
    assert sorted(c.rid for c in s.completions) == list(range(9))
    for c in s.completions:
        want = cpu_engine.run(reqs[c.rid], "accel")["head"].numpy()
        np.testing.assert_array_equal(c.outputs["head"], want)
