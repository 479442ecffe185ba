"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the engine and scheduler on the card against the same engine
on the CPU. The int8 kernels are bit-exact, except sigmoid (1e-6
relative: the kernel's expf and PyTorch's sigmoid may differ by an ulp);
the fp32 flex path agrees to 1e-4 (cuDNN and the CPU convolution sum in
different orders). The fp32 LM kernels sum in another order than their
plain versions (cuBLAS products, a softmax over whole rows, torch.cumsum)
and use the card's expf: flash attention is held to 2e-5 and the SSD scan
to 1e-4, the reference's own kernel-vs-reference tolerances
(tests/test_kernels.py, tests/test_ssd_kernel.py).

Every test here needs a CUDA card and is marked ``gpu``; without a card
they skip. This file imports nothing of the JAX reference, so it runs on
the GPU machine:

    python -m pytest -m gpu tests/test_torch_*.py

The autotuner's kernel variants (the channel-blocked int8 conv grid, a
pre-padded input, prepacked matmul weights) are bit-exact to the plain
versions; the fp32 conv is held to 1e-4, the reference's own tolerance
for its fp32 conv kernel (tests/test_kernels.py). The VAE's sampler holds
its threefry bits exactly and eps and the sample to 2e-6 relative (atol
1e-6): the card's log1pf and expf against PyTorch's.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import ContinuousBatchingScheduler
from repro_torch.core.lm import LMEngine
from repro_torch.kernels import build
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import sample as tsample
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.epilogue import pad_channel_params
from repro_torch.models import cnet_plus_scalar as tcnet
from repro_torch.models import lm as tlm
from repro_torch.models import vae_encoder as tvae

pytestmark = pytest.mark.gpu

NARROW = dict(input_shape=(32, 32, 2), channels=(8, 8, 4), dense=12)
REQUANT = 0.0123456789


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("m,k,n,forced", [
    (1, 5, 3, None), (16, 32769, 92, None), (16, 92, 1, None),
    (33, 300, 130, None),           # the tile kernel, by the rule
    (31, 300, 130, "splitk"),       # split-K: two row tiles, the last ragged
    (33, 300, 130, "splitk")])      # split-K: three row tiles
@pytest.mark.parametrize("act,requant,bias", [
    (None, None, True), ("relu", REQUANT, True), ("sigmoid", None, False)])
def test_int8_matmul_kernel_matches_plain(cuda_device, monkeypatch, m, k, n,
                                          forced, act, requant, bias):
    if forced is not None:
        monkeypatch.setattr(tmm, "route", lambda m, k, n: forced)
    which = tmm.route(m, k, n)
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g) if bias else None
    args = [v.to(cuda_device) if v is not None else None
            for v in (x, w, xs, ws, b)]
    kops.reset_launch_counts()
    got = tmm.int8_matmul(*args, act=act, requant_scale=requant)
    torch.cuda.synchronize()
    assert tmm.launches == 1 and kops.route_counts()[which] == 1
    want = tmm.int8_matmul_plain(*args, act, requant)
    if act == "sigmoid":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,cin,cout,stride,padding", [
    (2, 10, 9, 4, 3, 2, "VALID"), (3, 37, 70, 2, 48, 1, "SAME"),
    (2, 64, 64, 48, 32, 1, "SAME"), (1, 9, 11, 5, 7, 2, "SAME"),
    # the implicit-GEMM kernel's edges: im2col Cin (3, 20), in-place Cin
    # (48, 64, 128), Cout not a multiple of 8, Ho/Wo not multiples of the
    # 4 x 32 tile, stride 2 SAME and VALID, two 64-channel passes, and
    # CNet's stem at B=16 and B=4 (tiles of 4 and of 2 sub-tiles, more
    # tiles than the persistent blocks)
    (2, 13, 45, 3, 9, 2, "SAME"), (1, 9, 70, 20, 12, 1, "SAME"),
    (2, 17, 35, 48, 48, 1, "SAME"), (1, 12, 33, 64, 7, 2, "VALID"),
    (1, 11, 40, 128, 24, 1, "SAME"), (1, 6, 9, 16, 70, 1, "SAME"),
    (16, 256, 256, 2, 48, 1, "SAME"), (4, 256, 256, 2, 48, 1, "SAME")])
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


# the weights calibration quantizes: CNet's five, the LM's eleven at
# zamba2-1.2b widths (five distinct shapes); then one row of 4097 columns
# and N = 3, which take one column a thread
QUANTIZE_SHAPES = [(18, 48), (32769, 92), (92, 1), (432, 48), (432, 32),
                   (2048, 2048), (2048, 4096), (2048, 64), (4096, 2048),
                   (2048, 32000), (1, 4097), (257, 3)]


@pytest.mark.parametrize("m,n", QUANTIZE_SHAPES)
def test_quantize_apply_kernel_matches_plain(cuda_device, m, n):
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, n), generator=g).to(cuda_device)
    scale = x.abs().amax(0) / 127.0 + 1e-12
    before = tquant.launches
    got = tquant.quantize_apply(x, scale)
    torch.cuda.synchronize()
    assert tquant.launches == before + 1
    assert torch.equal(got, tquant.quantize_apply_plain(x, scale))
    q, s = tquant.quantize(x)
    assert torch.equal(s, scale) and torch.equal(q, got)


@pytest.mark.parametrize("m,n", [(2048, 64), (33, 4096), (5, 4)])
def test_quantize_apply_kernel_reads_a_misaligned_view(cuda_device, m, n):
    """A contiguous view that starts 4 bytes into its storage takes one
    column a thread, and the kernel refuses four there."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(m * n + 1, generator=g).to(cuda_device)[1:].view(m, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = x.abs().amax(0) / 127.0 + 1e-12
    q = torch.empty((m, n), dtype=torch.int8, device=cuda_device)
    assert tquant.vector_width(x, q) == 1
    before = tquant.launches
    got = tquant.quantize_apply(x, scale)
    torch.cuda.synchronize()
    assert tquant.launches == before + 1
    assert torch.equal(got, tquant.quantize_apply_plain(x, scale))
    lib = build.library("quantize_apply")
    fn = lib.quantize_apply
    fn.argtypes, fn.restype = tquant._ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), scale.data_ptr(), q.data_ptr(), m, n, 1,
            build.stream(x))
    assert rc != 0 and "misaligned" in lib.error_string(rc).decode()


def test_quantize_apply_indexes_past_2_to_the_31(cuda_device):
    """M * N just past 2^31 (M = 65,537, N = 32,768; 8.6 GB in): rows at
    both ends against the plain version on the same rows (rows are
    independent), so no second fp32 copy is held."""
    m, n = 65_537, 32_768
    g = torch.Generator(device=cuda_device).manual_seed(31)
    x = torch.randn((m, n), generator=g, device=cuda_device)
    scale = x.abs().amax(0) / 127.0 + 1e-12
    got = tquant.quantize_apply(x, scale)
    torch.cuda.synchronize()
    assert m * n > 2 ** 31
    for rows in (slice(0, 64), slice(m - 64, m)):
        assert torch.equal(got[rows],
                           tquant.quantize_apply_plain(x[rows], scale))


def test_card_engine_matches_cpu_engine(cuda_device, cpu_engine):
    batch = tcnet.synthetic_batch(np.random.default_rng(7), 6,
                                  NARROW["input_shape"])
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    kops.reset_launch_counts()
    got = card.run_batch(batch, "accel")["head"].cpu()
    assert kops.launch_counts() == {"int8_matmul": 2, "conv2d_int8": 3,
                                    "conv2d_int8_cout_blocks": 0,
                                    "conv2d": 0, "quantize_apply": 0,
                                    "flash_attention": 0, "ssd": 0,
                                    "sample_normal": 0}
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


def test_int8_matmul_indexes_past_2_to_the_31(cuda_device):
    """M * N just past 2^31 (M = 65,600, N = 32,768): rows at both ends
    against the plain version on the same rows (rows are independent)."""
    g = torch.Generator().manual_seed(31)
    m, k, n = 65_600, 8, 32_768
    x = torch.randint(-127, 128, (m, k), generator=g,
                      dtype=torch.int8).to(cuda_device)
    w = torch.randint(-127, 128, (k, n), generator=g,
                      dtype=torch.int8).to(cuda_device)
    xs = (torch.rand(m, generator=g) * 0.01 + 1e-3).to(cuda_device)
    ws = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda_device)
    got = tmm.int8_matmul(x, w, xs, ws)
    torch.cuda.synchronize()
    assert m * n > 2 ** 31
    for rows in (slice(0, 64), slice(m - 64, m)):
        want = tmm.int8_matmul_plain(x[rows], w, xs[rows], ws)
        assert torch.equal(got[rows], want)
    del got


# the tile kernel's shapes: M past split-K's 32 up to a B=4 prefill, K and N
# ragged and not 16-byte aligned (byte-load staging) as well as the LM's
# aligned widths; the [8192, 32000] head only at its own K
TILE_SHAPES = [(m, k, n) for m in (65, 200, 8192) for k in (8, 92, 2048, 4099)
               for n in (1, 64, 130, 32000)
               if not (m == 8192 and n == 32000 and k != 2048)]


@pytest.mark.parametrize("m,k,n", TILE_SHAPES)
@pytest.mark.parametrize("act,requant,bias", [
    (None, None, True), ("relu", REQUANT, True), ("sigmoid", None, False)])
def test_int8_matmul_tile_kernel_matches_plain(cuda_device, monkeypatch, m,
                                               k, n, act, requant, bias):
    # K = 8 is below the rule's wgmma step: force the tile kernel
    monkeypatch.setattr(tmm, "route", lambda m, k, n: "tile")
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g) if bias else None
    args = [v.to(cuda_device) if v is not None else None
            for v in (x, w, xs, ws, b)]
    before = tmm.launches_tile
    got = tmm.int8_matmul(*args, act=act, requant_scale=requant)
    torch.cuda.synchronize()
    assert tmm.launches_tile == before + 1
    want = tmm.int8_matmul_plain(*args, act, requant)
    if act == "sigmoid":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,kp,n,np_,bk,bn", [
    (300, 2048, 2048, 2000, 2048, 1024, 256),    # n_out < np, K = kp
    (100, 70, 128, 13, 16, 128, 16),             # k < kp, ragged
    (2048, 2048, 2048, 32000, 32000, 1024, 256)])  # the tuned LM head
@pytest.mark.parametrize("act,requant", [("relu", REQUANT), (None, None)])
def test_int8_matmul_prepacked_tile_kernel_matches_plain(
        cuda_device, m, k, kp, n, np_, bk, bn, act, requant):
    """A prepacked [kp, np] arena read in place by the tile kernel: row
    stride ldw = np, x's logical K, ``n_out`` columns written."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g)
    wp = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    wsp, bp = pad_channel_params(ws, b, np_ - n)
    dev = [v.to(cuda_device) for v in (x, wp, xs, wsp, bp)]
    assert tmm.route(m, k, n) == "tile"
    before = tmm.launches_tile
    got = tmm.int8_matmul(*dev, act=act, requant_scale=requant, bm=128,
                          bn=bn, bk=bk, prepacked=True, n_out=n)
    torch.cuda.synchronize()
    assert tmm.launches_tile == before + 1
    want = tmm.int8_matmul_plain(*[v.to(cuda_device)
                                   for v in (x, w, xs, ws, b)], act, requant)
    assert torch.equal(got, want)


def test_int8_matmul_route_counters_show_the_kernel_that_ran(cuda_device,
                                                            monkeypatch):
    """The rule's choice is what launches, and the counters say which;
    both kernels give the same bits on the same operands."""
    rule = tmm.route
    g = torch.Generator().manual_seed(9)
    outs = {}
    for m in (4, 100):
        x = torch.randint(-127, 128, (m, 4096), generator=g,
                          dtype=torch.int8).to(cuda_device)
        w = torch.randint(-127, 128, (4096, 96), generator=g,
                          dtype=torch.int8).to(cuda_device)
        xs, ws = torch.ones(m, device=cuda_device), torch.ones(
            96, device=cuda_device)
        for kernel in (None, "tile", "splitk"):
            monkeypatch.setattr(tmm, "route", rule if kernel is None
                                else lambda m, k, n, r=kernel: r)
            kops.reset_launch_counts()
            outs[m, kernel] = tmm.int8_matmul(x, w, xs, ws)
            torch.cuda.synchronize()
            ran = kernel or rule(m, 4096, 96)
            assert kops.route_counts() == {
                "tile": int(ran == "tile"), "splitk": int(ran == "splitk")}
            assert kops.launch_counts()["int8_matmul"] == 1
        assert torch.equal(outs[m, "tile"], outs[m, "splitk"])
        assert torch.equal(outs[m, None], outs[m, "tile"])
    assert rule(4, 4096, 96) == "splitk"
    assert rule(100, 4096, 96) == "tile"


def test_int8_matmul_tile_indexes_past_2_to_the_31(cuda_device):
    """The tile kernel at M * N just past 2^31 (M = 65,600, N = 32,768):
    rows at both ends against the plain version on the same rows."""
    g = torch.Generator().manual_seed(31)
    m, k, n = 65_600, 40, 32_768
    x = torch.randint(-127, 128, (m, k), generator=g,
                      dtype=torch.int8).to(cuda_device)
    w = torch.randint(-127, 128, (k, n), generator=g,
                      dtype=torch.int8).to(cuda_device)
    xs = (torch.rand(m, generator=g) * 0.01 + 1e-3).to(cuda_device)
    ws = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda_device)
    assert tmm.route(m, k, n) == "tile"
    got = tmm.int8_matmul(x, w, xs, ws)
    torch.cuda.synchronize()
    assert m * n > 2 ** 31
    for rows in (slice(0, 64), slice(m - 64, m)):
        want = tmm.int8_matmul_plain(x[rows], w, xs[rows], ws)
        assert torch.equal(got[rows], want)
    del got


FLASH_CASES = [
    # b, sq, sk, hq, hkv, hd, causal
    (2, 37, 37, 4, 2, 8, True),          # GQA, ragged
    (2, 37, 37, 4, 2, 8, False),
    (1, 130, 130, 2, 2, 16, True),
    (1, 64, 100, 4, 1, 64, True),        # Sq < Sk
    (1, 100, 64, 4, 1, 64, False),       # Sq > Sk
    (2, 256, 256, 8, 8, 64, True),
    (1, 70, 70, 2, 1, 128, True),        # the hd <= 128 instantiation
    (1, 65, 65, 2, 2, 100, False),
    (1, 2048, 2048, 4, 4, 64, True),     # the LM's prefill shape, 4 heads
    (1, 512, 512, 4, 2, 128, True),      # hd 128 at S = 512
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, sq, sk, hq,
                                             hkv, hd, causal):
    g = torch.Generator().manual_seed(sq + sk + hd)
    q = torch.randn((b, sq, hq, hd), generator=g).to(cuda_device)
    k = torch.randn((b, sk, hkv, hd), generator=g).to(cuda_device)
    v = torch.randn((b, sk, hkv, hd), generator=g).to(cuda_device)
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    want = tflash.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_kernel_reads_strided_views(cuda_device):
    """q/k/v as views into one [B, S, 3, H, hd] buffer: read in place."""
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn((2, 50, 3, 4, 16), generator=g).to(cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = tflash.flash_attention(q, k, v, causal=True)
    want = tflash.flash_attention_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


SSD_CASES = [
    # b, s, h, p, n, chunk, init
    (2, 64, 3, 8, 16, 16, False),
    (2, 96, 2, 8, 8, 64, True),          # chunk falls back to 48
    (1, 300, 2, 64, 64, 256, False),     # 150: not a multiple of 64
    (1, 512, 4, 64, 64, 256, True),
    (1, 128, 2, 16, 128, 64, False),     # the N <= 128 instantiation
    (2, 37, 2, 8, 8, 256, True),         # prime S: one chunk of 37
    (4, 2048, 64, 64, 64, 256, False),   # the LM's served prefill
    (1, 1000, 64, 64, 64, 256, False),   # chunk 250: ragged strips
    (1, 1000, 64, 64, 64, 256, True),
]


def _ssd_inputs(b, s, h, p, n, init, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g)
    B_ = torch.randn((b, s, n), generator=g)
    C_ = torch.randn((b, s, n), generator=g)
    dt = torch.rand((b, s, h), generator=g) * 0.5 + 0.05
    A = -(torch.rand(h, generator=g) + 0.5)
    st = torch.randn((b, h, p, n), generator=g) if init else None
    return [None if t is None else t.to(device)
            for t in (x, B_, C_, dt, A, st)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk, init):
    x, B_, C_, dt, A, st = _ssd_inputs(b, s, h, p, n, init, s + n,
                                       cuda_device)
    before = tssd.launches
    y, fin = tssd.ssd(x, B_, C_, dt, A, st, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.launches == before + 1
    y_p, fin_p = tssd.ssd_plain(x, B_, C_, dt, A, st, chunk)
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fin, fin_p, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_carries_init_state(cuda_device):
    """Two halves with the carried state equal one run over the whole."""
    x, B_, C_, dt, A, _ = _ssd_inputs(1, 512, 2, 64, 64, False, 9,
                                      cuda_device)
    y, fin = tssd.ssd(x, B_, C_, dt, A, chunk=128)
    y1, st = tssd.ssd(x[:, :256], B_[:, :256], C_[:, :256], dt[:, :256], A,
                      chunk=128)
    y2, fin2 = tssd.ssd(x[:, 256:], B_[:, 256:], C_[:, 256:], dt[:, 256:],
                        A, st, chunk=128)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(fin2, fin, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_split_run_at_the_served_shape(cuda_device):
    """The served prefill (B=4, S=2048, 64 heads of 64, N = 64) in two
    halves with the carried state against the whole run and the plain
    version of the second half."""
    x, B_, C_, dt, A, _ = _ssd_inputs(4, 2048, 64, 64, 64, False, 21,
                                      cuda_device)
    y, fin = tssd.ssd(x, B_, C_, dt, A)
    half = [slice(None, 1024), slice(1024, None)]
    parts = [[t[:, sl] for t in (x, B_, C_, dt)] for sl in half]
    y1, st = tssd.ssd(*parts[0], A)
    y2, fin2 = tssd.ssd(*parts[1], A, st)
    y2_p, fin2_p = tssd.ssd_plain(*parts[1], A, st)
    for got, want in ((torch.cat([y1, y2], 1), y), (fin2, fin),
                      (y2, y2_p), (fin2, fin2_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the split-K kernel's shapes: CNet's fc1 and head (plain and in their
# tuned prepacked layouts: K rows, row stride), the LM decode step's
# K > 2048 product at 4 lanes, ESPERTA's K = 3, N = 1, ragged M in the
# three staging modes (16-, 4- and 1-byte pieces), K at one and two
# blocks, and the most rows one launch takes
SPLITK_SHAPES = [
    (16, 32769, 92, None), (16, 32769, 92, (33792, 96)),
    (16, 92, 1, None), (16, 92, 1, (96, 8)), (4, 4096, 2048, None),
    (16, 3, 1, None), (5, 3, 1, None), (33, 300, 144, None),
    (31, 600, 132, None), (33, 300, 130, None), (3, 257, 7, None),
    (17, 256, 64, None), (tmm.ROWS_PER_BLOCK * tmm.MAX_GRID_Z, 3, 1, None)]


@pytest.mark.parametrize("m,k,n,packed", SPLITK_SHAPES)
@pytest.mark.parametrize("act,requant", [("relu", REQUANT), (None, None),
                                         ("sigmoid", None)])
def test_split_k_kernel_is_bit_exact_twice_in_a_row(cuda_device, monkeypatch,
                                                    m, k, n, packed, act,
                                                    requant):
    """Bit-exact against the plain version (sigmoid: 1e-6 relative), and
    a second call right after the first (the persistent scratch, zeroed
    again by the first call's last blocks, no memset) gives the same."""
    monkeypatch.setattr(tmm, "route", lambda m, k, n: "splitk")
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g)
    dev = [v.to(cuda_device) for v in (x, w, xs, ws, b)]
    if packed is None:
        args, kw = dev, {}
    else:
        kp, np_ = packed
        wp = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
        wsp, bp = pad_channel_params(ws, b, np_ - n)
        args = [dev[0], wp.to(cuda_device), dev[2], wsp.to(cuda_device),
                bp.to(cuda_device)]
        kw = dict(bm=16, bn=np_, bk=kp, prepacked=True, n_out=n)
    want = tmm.int8_matmul_plain(*dev, act, requant)
    kops.reset_launch_counts()
    for _ in range(2):
        got = tmm.int8_matmul(*args, act=act, requant_scale=requant, **kw)
        torch.cuda.synchronize()
        if act == "sigmoid":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, want)
    assert kops.route_counts()["splitk"] == 2


def test_card_lm_prefill_state_matches_cpu(cuda_device):
    """The SSD state a prefill caches (the kernel's final state) within
    1e-4 of the CPU engine's (ssd_plain's), on the same weights,
    calibration and prompts."""
    cfg = tlm.DEFAULT_CONFIG
    graph = tlm.build_graph(cfg)
    cpu = Engine(graph, tlm.init_params(0, cfg), device="cpu")
    cpu.calibrate([tlm.synthetic_input(np.random.default_rng(1), cfg)
                   for _ in range(4)])
    card = Engine(graph, cpu.params, device=cuda_device)
    card.share_calibration(cpu)
    x = tlm.synthetic_batch(np.random.default_rng(4), 3, cfg)["x"]
    slots = np.array([1, 0, 2], np.int32)
    for backend in ("accel", "flex"):
        lms = [LMEngine(e, backend, n_slots=3, max_new_tokens=4)
               for e in (cpu, card)]
        for lm in lms:
            lm.prefill(x, slots)
        (name,) = lms[0]._ssd_nodes
        torch.testing.assert_close(lms[1].caches[name]["state"].cpu(),
                                   lms[0].caches[name]["state"], rtol=1e-4,
                                   atol=1e-4)


def test_card_lm_engine_matches_cpu_engine(cuda_device):
    """The small LM block on the card against the CPU engine with the same
    weights and calibration: prefill K/V cache codes and scales bit-exact
    (exact int8 projections), logits within 1e-4, and the kernels
    launched once per prefill, never in decode."""
    cfg = tlm.DEFAULT_CONFIG
    graph = tlm.build_graph(cfg)
    cpu = Engine(graph, tlm.init_params(0, cfg), device="cpu")
    rng = np.random.default_rng(1)
    cpu.calibrate([tlm.synthetic_input(rng, cfg) for _ in range(4)])
    card = Engine(graph, cpu.params, device=cuda_device)
    card.share_calibration(cpu)
    lm_c = LMEngine(cpu, "accel", n_slots=2, max_new_tokens=4)
    lm_g = LMEngine(card, "accel", n_slots=2, max_new_tokens=4)
    x = tlm.synthetic_batch(np.random.default_rng(3), 2, cfg)["x"]
    slots = np.array([0, 1], np.int32)
    kops.reset_launch_counts()
    rc, rg = lm_c.prefill(x, slots), lm_g.prefill(x, slots)
    counts = kops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["ssd"] == 1
    assert counts["int8_matmul"] == len(lm_g.plan.qplans)
    for w in ("k_codes", "k_scale", "v_codes", "v_scale"):
        assert torch.equal(lm_g.caches["attn"][w].cpu(),
                           lm_c.caches["attn"][w])
    np.testing.assert_allclose(rg.hidden, rc.hidden, rtol=1e-4, atol=1e-4)
    kops.reset_launch_counts()
    lm_g.decode_step(rg.hidden, slots)
    counts = kops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd"] == 0
    assert counts["int8_matmul"] == len(lm_g.plan.qplans)


# ---------------------------------------------------------------------------
# the autotuner's kernel variants and the fp32 conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,cin,cout,bc,stride,padding,rows", [
    (2, 9, 7, 3, 12, 8, 1, "SAME", 3),       # Cout not a multiple of bc
    (2, 10, 10, 4, 9, 8, 2, "SAME", 3),
    (3, 17, 33, 5, 20, 16, 2, "VALID", 4),
    (16, 256, 256, 2, 48, 16, 1, "SAME", 256),   # CNet's tuned act0
    (1, 32, 32, 128, 512, 64, 1, "SAME", 8),     # too wide for one block
    (2, 11, 37, 20, 20, 8, 2, "VALID", 4),       # im2col, K 180
    (1, 12, 35, 64, 28, 16, 1, "SAME", 5)])      # in place, 2 blocks
@pytest.mark.parametrize("pre_padded", [False, True])
@pytest.mark.parametrize("requant,bias", [(0.05, True), (None, False)])
def test_conv2d_int8_cout_blocks_kernel_matches_plain(
        cuda_device, b, h, w, cin, cout, bc, stride, padding, rows,
        pre_padded, requant, bias):
    g = torch.Generator().manual_seed(b + h + w + cin + cout)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=g,
                      dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(cout, generator=g) * 0.01).to(cuda_device)
    bb = torch.randn(cout, generator=g).to(cuda_device) if bias else None
    kw = dict(x_scale=0.0377, stride=stride, padding=padding, act="relu",
              requant_scale=requant, rows_per_block=rows, cout_per_block=bc)
    if pre_padded:
        # the arena's layout: channels padded to whole blocks, neutral
        # scale/bias on the pad channels, the input staged at plan time
        pad_c = -(-cout // bc) * bc - cout
        wq = torch.nn.functional.pad(wq, (0, pad_c))
        ws, bb = pad_channel_params(ws, bb, pad_c)
        geom = tconv.conv_geometry(h, w, 3, 3, stride, padding, rows)
        x = tconv.pad_input(x, geom)
        kw.update(cout=cout, pre_padded=True, in_hw=(h, w))
    before = (tconv.launches, tconv.launches_cout_blocks)
    got = tconv.conv2d_int8(x, wq, ws, bb, **kw)
    torch.cuda.synchronize()
    assert (tconv.launches, tconv.launches_cout_blocks) == (
        before[0], before[1] + 1)
    want = tconv.conv2d_int8_plain(x, wq, ws, bb, **{
        k: v for k, v in kw.items() if k != "cout_per_block"})
    assert got.shape[-1] == cout
    assert torch.equal(got, want)


def test_conv2d_int8_whole_cout_pre_padded_matches_plain(cuda_device):
    """The tuned act1/act2 path: the whole-Cout grid on an input staged at
    rows_per_block 128 (more bottom rows than the kernel's row tile)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (4, 128, 128, 48), generator=g,
                      dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (3, 3, 48, 48), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(48, generator=g) * 0.01).to(cuda_device)
    bb = torch.randn(48, generator=g).to(cuda_device)
    geom = tconv.conv_geometry(128, 128, 3, 3, 1, "SAME", 128)
    xp = tconv.pad_input(x, geom)
    kw = dict(x_scale=0.02, act="relu", requant_scale=0.0163)
    before = tconv.launches
    got = tconv.conv2d_int8(xp, wq, ws, bb, rows_per_block=128,
                            pre_padded=True, in_hw=(128, 128), **kw)
    torch.cuda.synchronize()
    assert tconv.launches == before + 1
    assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, bb, **kw))


@pytest.mark.parametrize("m,k,kp,n,np_,bk,bn", [
    (5, 70, 128, 13, 16, 128, 16),           # k < kp, n_out < np
    (4, 50, 64, 10, 16, 64, 16),
    (16, 32769, 33792, 92, 96, 1024, 96),    # CNet fc1, packed
    (16, 92, 96, 1, 8, 96, 8)])              # CNet head, packed
@pytest.mark.parametrize("act,requant", [("relu", REQUANT), (None, None)])
def test_int8_matmul_prepacked_kernel_matches_plain(cuda_device, m, k, kp,
                                                    n, np_, bk, bn, act,
                                                    requant):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand(m, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, generator=g)
    wp = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    wsp, bp = pad_channel_params(ws, b, np_ - n)
    dev = [v.to(cuda_device) for v in (x, wp, xs, wsp, bp)]
    before = tmm.launches
    got = tmm.int8_matmul(*dev, act=act, requant_scale=requant, bm=8,
                          bn=bn, bk=bk, prepacked=True, n_out=n)
    torch.cuda.synchronize()
    assert tmm.launches == before + 1
    want = tmm.int8_matmul_plain(*[v.to(cuda_device)
                                   for v in (x, w, xs, ws, b)], act, requant)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,cin,cout,kh,stride,padding", [
    (2, 16, 16, 3, 8, 3, 1, "SAME"), (2, 16, 16, 3, 8, 3, 2, "SAME"),
    (2, 12, 20, 4, 16, 5, 1, "VALID"), (16, 128, 256, 3, 8, 3, 2, "SAME"),
    (2, 9, 9, 2, 4, 3, 2, "VALID"), (2, 14, 18, 3, 8, 3, 2, "VALID"),
    (4, 256, 256, 2, 48, 3, 1, "SAME"),
    (1, 20, 20, 96, 150, 3, 1, "SAME"),      # several channel blocks
    # the implicit-GEMM kernel's edges: im2col Cin (5, 20), in-place Cin
    # (32, 64), Cout not a multiple of 8, stride 2 SAME and VALID, and
    # CNet's fp32 stem at B=16 (more tiles than persistent blocks)
    (1, 11, 37, 5, 7, 3, 2, "SAME"), (2, 9, 40, 20, 9, 3, 1, "VALID"),
    (1, 10, 34, 32, 3, 3, 2, "SAME"), (1, 6, 33, 64, 12, 3, 1, "SAME"),
    (2, 13, 45, 3, 9, 3, 2, "VALID"), (16, 256, 256, 2, 48, 3, 1, "SAME")])
@pytest.mark.parametrize("relu,bias", [(True, True), (False, False)])
def test_conv2d_f32_kernel_matches_plain(cuda_device, b, h, w, cin, cout,
                                         kh, stride, padding, relu, bias):
    g = torch.Generator().manual_seed(h * 31 + w)
    x = torch.randn((b, h, w, cin), generator=g).to(cuda_device)
    wt = (torch.randn((kh, kh, cin, cout), generator=g) * 0.1).to(
        cuda_device)
    bb = (torch.randn(cout, generator=g) * 0.1).to(cuda_device) \
        if bias else None
    before = kops.launch_counts()["conv2d"]
    got = kops.conv2d(x, wt, bb, stride=stride, padding=padding, relu=relu)
    torch.cuda.synchronize()
    assert kops.launch_counts()["conv2d"] == before + 1
    want = kops.conv2d_plain(x, wt, bb, stride=stride, padding=padding,
                             relu=relu)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_conv_kernels_read_misaligned_views(cuda_device):
    """An input view that does not start on a 16-byte boundary (the
    kernels copy with 16-byte cp.async) is copied once and convolved
    right."""
    g = torch.Generator().manual_seed(9)
    xb = torch.randint(-127, 128, (3, 9, 21, 2), generator=g,
                       dtype=torch.int8).to(cuda_device)
    x = xb.view(-1)[1:1 + 2 * 9 * 21 * 2].view(2, 9, 21, 2)
    assert x.data_ptr() % 16 != 0
    wq = torch.randint(-127, 128, (3, 3, 2, 8), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(8, generator=g) * 0.01).to(cuda_device)
    kw = dict(x_scale=0.02, act="relu", requant_scale=0.05)
    got = tconv.conv2d_int8(x, wq, ws, **kw)
    assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, **kw))
    xf = torch.randn((3, 9, 21, 3), generator=g).to(cuda_device)
    xf = xf.view(-1)[1:1 + 2 * 9 * 21 * 3].view(2, 9, 21, 3)
    wf = (torch.randn((3, 3, 3, 8), generator=g) * 0.1).to(cuda_device)
    torch.testing.assert_close(kops.conv2d(xf, wf), kops.conv2d_plain(xf, wf),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("msub", [1, 2, 4])
def test_conv_kernels_match_plain_at_every_sub_tile_count(cuda_device,
                                                          monkeypatch, msub):
    """Tiles of 1, 2 and 4 sub-tiles of 4 rows (the wrapper's pick is a
    schedule only): both int8 grids, im2col and in place, and the fp32
    conv with padded and whole pixels, each equal to its plain version."""
    monkeypatch.setattr(tconv, "sub_tiles", lambda *a: msub)
    g = torch.Generator().manual_seed(msub)
    # (B, H, W, Cin, Cout, bc, stride): every footprint fits at msub 4
    for (b, h, w, cin, cout, bc, stride) in ((2, 37, 70, 2, 48, 0, 1),
                                            (2, 21, 45, 32, 20, 8, 2),
                                            (1, 30, 33, 5, 9, 0, 2)):
        x = torch.randint(-127, 128, (b, h, w, cin), generator=g,
                          dtype=torch.int8).to(cuda_device)
        wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                           dtype=torch.int8).to(cuda_device)
        ws = (torch.rand(cout, generator=g) * 0.01).to(cuda_device)
        bb = torch.randn(cout, generator=g).to(cuda_device)
        kw = dict(x_scale=0.02, stride=stride, act="relu",
                  requant_scale=0.05)
        got = tconv.conv2d_int8(x, wq, ws, bb, cout_per_block=bc, **kw)
        assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, bb, **kw))
    for (b, h, w, cin, cout, stride) in ((2, 37, 70, 2, 48, 1),
                                         (1, 30, 33, 3, 9, 2),
                                         (2, 21, 45, 8, 20, 1)):
        xf = torch.randn((b, h, w, cin), generator=g).to(cuda_device)
        wf = (torch.randn((3, 3, cin, cout), generator=g) * 0.1).to(
            cuda_device)
        torch.testing.assert_close(
            kops.conv2d(xf, wf, stride=stride, relu=True),
            kops.conv2d_plain(xf, wf, stride=stride, relu=True), rtol=1e-4,
            atol=1e-4)


def test_conv2d_int8_takes_more_images_than_a_grid_axis(cuda_device):
    """Persistent blocks walk the images, so 70,000 images (more than the
    65,535 blocks of a grid axis the earlier grid put them on) run in one
    launch, equal to the plain version."""
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-127, 128, (70000, 2, 3, 2), generator=g,
                      dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (3, 3, 2, 3), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(3, generator=g) * 0.01).to(cuda_device)
    kw = dict(x_scale=0.02, act="relu", requant_scale=0.05)
    before = tconv.launches
    got = tconv.conv2d_int8(x, wq, ws, **kw)
    torch.cuda.synchronize()
    assert tconv.launches == before + 1
    assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, **kw))


def test_cuda_tensors_the_kernels_cannot_take_raise(cuda_device):
    """No quiet fall back to the plain version: a CUDA operand set the
    kernel cannot launch on raises before launching."""
    before = kops.launch_counts()
    x = torch.zeros((1, 32, 32, 128), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((3, 3, 128, 512), dtype=torch.int8, device=cuda_device)
    ws = torch.ones(512, device=cuda_device)
    # a filter whose every slice of 8 channels is over 232,448 B (16 rows
    # of 3 x 3 x 4096 codes): no channel block fits one block
    xw = torch.zeros((1, 8, 8, 4096), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tconv.conv2d_int8(xw, torch.zeros((3, 3, 4096, 16), dtype=torch.int8,
                                          device=cuda_device),
                          torch.ones(16, device=cuda_device))
    with pytest.raises(ValueError, match="does not match geometry"):
        tconv.conv2d_int8(x, w, ws, cout_per_block=64, pre_padded=True,
                          in_hw=(32, 32))
    # channel blocks ride on gridDim.y: 65,536 blocks of one channel do not
    wn = torch.zeros((3, 3, 2, 65536), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="gridDim.y"):
        tconv.conv2d_int8(x[..., :2].contiguous(), wn,
                          torch.ones(65536, device=cuda_device),
                          cout_per_block=1)
    xf = torch.zeros((1, 8, 8, 4096), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        kops.conv2d(xf, torch.zeros((3, 3, 4096, 4), device=cuda_device))
    xq = torch.zeros((4, 70), dtype=torch.int8, device=cuda_device)
    wp = torch.zeros((128, 20), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="prepacked"):
        tmm.int8_matmul(xq, wp, torch.ones(4, device=cuda_device),
                        torch.ones(20, device=cuda_device), bn=16, bk=128,
                        prepacked=True, n_out=13)
    torch.cuda.synchronize()
    assert kops.launch_counts() == before


# the VAE's five stride-2 int8 convs at B=16: (H, W, Cin, Cout)
VAE_CONVS = ((128, 256, 3, 8), (64, 128, 8, 32), (32, 64, 32, 96),
             (16, 32, 96, 144), (8, 16, 144, 144))


@pytest.mark.parametrize("h,w,cin,cout", VAE_CONVS)
def test_vae_int8_convs_match_plain(cuda_device, h, w, cin, cout):
    """Bit-exact to the plain (whole-Cout) version at the served shapes,
    each one launch counted as ``conv2d_int8``: the two whose filter slice
    does not fit one block (96 -> 144, 144 -> 144) run the channel-blocked
    grid with the largest block that fits."""
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randint(-127, 128, (16, h, w, cin), generator=g,
                      dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(cout, generator=g) * 0.01).to(cuda_device)
    b = torch.randn(cout, generator=g).to(cuda_device)
    kw = dict(x_scale=0.0211, stride=2, act="relu", requant_scale=0.0377)
    kops.reset_launch_counts()
    got = tconv.conv2d_int8(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert (tconv.launches, tconv.launches_cout_blocks) == (1, 0)
    fits = tconv.smem_bytes(cin, cout, 3, 3, 2) <= tconv._SMEM_LIMIT
    assert fits == (cout < 144)
    assert torch.equal(got, tconv.conv2d_int8_plain(x, wq, ws, b, **kw))


@pytest.mark.parametrize("b,n", [(16, 6), (3, 1000), (1, 70000)])
def test_sample_normal_kernel_matches_plain(cuda_device, b, n):
    """The kernel's threefry bits equal the plain version's exactly; eps
    (mu = 0, logvar = 0) and a sample hold to the plain version within
    2e-6 relative (atol 1e-6): the card's log1pf and expf against
    PyTorch's."""
    rng = np.random.default_rng(b + n)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(b, 2),
                                         dtype=np.uint32).astype(np.int64))
    keys[0] = 2 ** 32 - 1
    kops.reset_launch_counts()
    bits = tsample.random_bits_kernel(keys, n, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), tsample.random_bits(keys, n))
    zeros = torch.zeros((b, n), device=cuda_device)
    eps = kops.sample_normal(zeros, zeros, keys)
    torch.cuda.synchronize()
    torch.testing.assert_close(eps.cpu(), tsample.normal_plain(keys, n),
                               rtol=2e-6, atol=1e-6)
    mu = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    lv = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    got = kops.sample_normal(mu.to(cuda_device), lv.to(cuda_device), keys)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(),
                               tsample.sample_normal_plain(mu, lv, keys),
                               rtol=2e-6, atol=1e-6)
    assert kops.launch_counts()["sample_normal"] == 3


def test_card_vae_engine_matches_cpu_engine(cuda_device):
    """A narrow VAE (32x64x3, the published channels) on the card against
    the same engine on the CPU: mu and logvar bit-exact (an int8 chain),
    the sample within 2e-6 given the same keys; one sampler launch."""
    shape = (32, 64, 3)
    cpu = Engine(tvae.build_graph(shape), tvae.init_params(3, shape),
                 device="cpu")
    rng = np.random.default_rng(3)
    cpu.calibrate([tvae.synthetic_input(rng, shape) for _ in range(4)])
    card = Engine(cpu.graph, {n: {k: v.to(cuda_device) for k, v in p.items()}
                              for n, p in cpu.params.items()},
                  device=cuda_device)
    card.share_calibration(cpu)
    batch = tvae.synthetic_batch(rng, 4, shape)
    keys = rng.integers(0, 2 ** 32, size=(4, 2), dtype=np.uint32)
    want = cpu.run_batch(batch, "accel", rngs=keys)
    kops.reset_launch_counts()
    got = card.run_batch(batch, "accel", rngs=keys)
    torch.cuda.synchronize()
    assert kops.launch_counts()["sample_normal"] == 1
    assert torch.equal(got["mu"].cpu(), want["mu"])
    assert torch.equal(got["logvar"].cpu(), want["logvar"])
    torch.testing.assert_close(got["sample"].cpu(), want["sample"],
                               rtol=2e-6, atol=1e-6)


def test_card_autotuned_engine_matches_cpu_engine(cuda_device):
    """A CNet with the published 256x256x2 -> 48 stem, autotuned on the
    card (act0 takes the channel-blocked grid), against the untuned CPU
    engine: bit-exact, one channel-blocked launch per dispatch."""
    widths = dict(input_shape=(256, 256, 2), channels=(48, 8, 4), dense=12)
    g = tcnet.build_graph(**widths)
    cpu = Engine(g, tcnet.init_params(3, **widths), device="cpu")
    rng = np.random.default_rng(3)
    cpu.calibrate([tcnet.synthetic_input(rng, widths["input_shape"])
                   for _ in range(2)])
    card = Engine(g, cpu.params, device=cuda_device, autotune=True)
    card.share_calibration(cpu)
    batch = tcnet.synthetic_batch(np.random.default_rng(7), 4,
                                  widths["input_shape"])
    card.compile("accel", 4)
    kops.reset_launch_counts()
    got = card.run_batch(batch, "accel")["head"].cpu()
    counts = kops.launch_counts()
    assert counts["conv2d_int8_cout_blocks"] == 1, counts
    assert counts["conv2d_int8"] == 2 and counts["int8_matmul"] == 2, counts
    assert card.planned("accel")._tuning[4]["act0"].config.cout_per_block
    assert torch.equal(got, cpu.run_batch(batch, "accel")["head"])


def test_measured_refinement_times_distinct_launches_on_the_card(
        cuda_device):
    """The opt-in measured refinement on the card: it times one candidate
    per channel blocking (the only setting that changes the conv launch),
    skips the whole-Cout candidate the wrapper refuses (3x3x128 -> 512
    needs 590 KB of filter), and never times the matmul's candidates,
    whose launches are all the same."""
    from repro_torch.core import autotune as tat
    from repro_torch.core import energy as tenergy
    hw = tenergy.BACKEND_HW["accel"]
    tuner = tat.Autotuner(tat.TuningCache(None), measure=True,
                          measure_repeats=1)
    assert tuner.device.type == "cuda"
    dec = tuner._search("int8_conv", (1, 32, 32, 128, 3, 3, 512, 1, "SAME"),
                        hw, True, None)
    assert dec.source == "measured" and dec.config.cout_per_block
    assert 1 <= tuner.stats["measured"] <= tuner.measure_top_k
    n = tuner.stats["measured"]
    dec = tuner._search("int8_dense", (16, 32769, 92), hw, True, None)
    assert dec.source == "model" and tuner.stats["measured"] == n


# ---------------------------------------------------------------------------
# the degraded-mode stack on the card (core/faults.py)
# ---------------------------------------------------------------------------


def _canaries(card, cpu_engine, reqs):
    """A canary of the same request on each engine's accel pipeline."""
    from repro_torch.core import faults
    from repro_torch.core.pipeline import ServingPipeline
    return [faults.GoldenCanary("cnet_plus_scalar",
                                ServingPipeline(e, backend="accel",
                                                batch_size=1), reqs)
            for e in (card, cpu_engine)]


def test_card_flip_gives_the_cpu_engines_flipped_output(cuda_device,
                                                         cpu_engine):
    """A pinned flip in fc1 reaches the split-K kernel through the live
    arena: the card's canary output equals the CPU engine's under the
    same flip, bit for bit, and differs from the pristine one; a repack
    restores the pristine digest on both."""
    from repro_torch.core import faults
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    on_card, on_cpu = _canaries(card, cpu_engine, _requests(1, seed=31))
    assert on_card.digest == on_cpu.digest
    plans = [e.planned("accel") for e in (card, cpu_engine)]
    k, n = plans[1].host_weights["fc1_act"].shape   # fc1 + its ReLU
    for plan in plans:               # the scalar's row, the sign bit
        got = faults.SEUInjector(0).flip(plan, node="fc1_act",
                                         byte=(k - 1) * n + 3, bit=7)
        assert got == ("fc1_act", (k - 1) * n + 3, 7)
    assert plans[0].weight_arena["fc1_act"].device.type == "cuda"
    outs = [c.run()["head"] for c in (on_card, on_cpu)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], on_card.reference["head"])
    assert not on_card.check()[0] and not on_cpu.check()[0]
    for plan in plans:
        plan.repack_weights()
    assert on_card.check()[0] and on_cpu.check()[0]


def test_card_canary_is_deterministic(cuda_device, cpu_engine):
    """20 canary checks with no flip all pass: every kernel on the accel
    path gives the same bits run to run."""
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    canary, _ = _canaries(card, cpu_engine, _requests(1, seed=32))
    kops.reset_launch_counts()
    assert all(canary.check()[0] for _ in range(20))
    counts = kops.launch_counts()
    assert (counts["conv2d_int8"], counts["int8_matmul"]) == (60, 40)


def test_card_staging_flip_is_transient(cuda_device, cpu_engine):
    """A flip in a pinned staging slot is overwritten by the next stage()
    before any dispatch reads it."""
    from repro_torch.core import faults
    from repro_torch.core.pipeline import ServingPipeline
    card = Engine(cpu_engine.graph, cpu_engine.params, device=cuda_device)
    card.share_calibration(cpu_engine)
    pipe = ServingPipeline(card, backend="accel", batch_size=4)
    assert pipe.arena._bufs[0]["image"].is_pinned()
    reqs = _requests(4, seed=33)
    ref = pipe.execute_batch(reqs)
    inj = faults.SEUInjector(0)
    for _ in range(8):
        inj.flip_staging(pipe.arena, slot=0)
    assert inj.n_flips == 8
    again = pipe.execute_batch(reqs)
    for k in ref.outputs:
        np.testing.assert_array_equal(again.outputs[k], ref.outputs[k])


# ---------------------------------------------------------------------------
# the sampler's gradient, the traced demo and a QAT step on the card
# ---------------------------------------------------------------------------


def test_sample_normal_gradient_matches_plain(cuda_device):
    """The kernel's autograd path (the kernel writes eps beside z; the
    backward is plain PyTorch) gives the CPU plain version's mu and logvar
    gradients under the same keys, within 2e-6 relative (atol 1e-6), with
    |mu| >> std where z - mu would cancel; a forward without a gradient
    writes no eps."""
    rng = np.random.default_rng(61)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(16, 2),
                                         dtype=np.uint32).astype(np.int64))
    mu0 = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32)
                           * 50.0)
    lv0 = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        mu = mu0.to(dev).requires_grad_(True)
        lv = lv0.to(dev).requires_grad_(True)
        kops.reset_launch_counts()
        z = kops.sample_normal(mu, lv, keys)
        (z * g.to(dev)).sum().backward()
        grads.append((z.detach().cpu(), mu.grad.cpu(), lv.grad.cpu()))
        assert z.grad_fn is not None
        assert kops.launch_counts()["sample_normal"] == (dev.type == "cuda")
    for got, want in zip(grads[0], grads[1]):
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)
    assert grads[0][2].abs().max() > 0
    with torch.no_grad():
        z = kops.sample_normal(mu0.to(cuda_device), lv0.to(cuda_device),
                               keys)
    assert z.grad_fn is None


def test_card_traced_demo_matches_cpu_engine(cuda_device):
    """The traced cloud-mask demo on the card against the CPU engine over
    the same weights and calibration: accel int8 results bit-exact where
    the chain is int8 from the input, cloud_prob within the ±1-code
    sigmoid rule (1e-6 relative), flags equal away from the threshold."""
    from repro_torch.frontend import demo
    tm = demo.build_traced()
    reqs = demo.synthetic_requests(8, seed=3)
    cpu = Engine(tm.graph, tm.params, device="cpu")
    cpu.calibrate(reqs[:4])
    card = Engine(tm.graph, tm.params, device=cuda_device)
    card.share_calibration(cpu)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    kops.reset_launch_counts()
    got = {k: v.cpu() for k, v in card.run_batch(batch, "accel").items()}
    want = cpu.run_batch(batch, "accel")
    counts = kops.launch_counts()
    assert counts["conv2d_int8"] > 0 and counts["int8_matmul"] > 0
    torch.testing.assert_close(got["cloud_prob"], want["cloud_prob"],
                               rtol=1e-4, atol=1e-6)
    off = (want["cloud_prob"] - demo.CLOUD_THRESHOLD).abs() > 1e-4
    assert torch.equal(got["cloud_flag"][off], want["cloud_flag"][off])


def test_card_qat_step_matches_cpu(cuda_device):
    """One distillation step of the QAT example on a narrow VAE: the card's
    loss and gradients within 1e-3 relative of the CPU port's (the loss
    differences outputs that agree to ~1e-3), the logvar head's gradient
    reaching through the sampler kernel."""
    from repro_torch.examples import qat_finetune as qat
    g = tvae.build_graph((16, 32, 3))
    params = tvae.init_params(0, (16, 32, 3))
    sample = tvae.synthetic_input(np.random.default_rng(0), (16, 32, 3))
    card_p = {n: {k: v.to(cuda_device) for k, v in p.items()}
              for n, p in params.items()}
    kops.reset_launch_counts()
    _, l_card, g_card = qat.distill_step(g, card_p, card_p, sample, 1e-3)
    assert kops.launch_counts()["sample_normal"] == 2
    _, l_cpu, g_cpu = qat.distill_step(g, params, params, sample, 1e-3)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-3 * float(l_cpu)
    for n in g_cpu:
        for k, want in g_cpu[n].items():
            err = (g_card[n][k].cpu() - want).abs().max()
            assert err <= 1e-3 * want.abs().max(), (n, k)
    assert g_card["logvar"]["w"].abs().max() > 0


# ---------------------------------------------------------------------------
# the large-model stack (configs/, nn/, launch/steps.py)
# ---------------------------------------------------------------------------


def _within_one_bf16_ulp(got, want, tol):
    """Each element within one bf16 ulp of the larger magnitude, plus the
    fp32 tolerance of the two computations (a value near zero can show
    their fp32 difference beyond one of its ulps)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((g - w).abs() <= ulp + tol * (1.0 + w.abs())).all())


@pytest.mark.parametrize("hkv", [8, 1])          # 1: 8:1 GQA, as tinyllama
def test_flash_attention_bf16_kernel_returns_bf16(cuda_device, hkv):
    g = torch.Generator().manual_seed(31)
    q, k, v = (torch.randn((2, 300, h, 64), generator=g).to(
        cuda_device, torch.bfloat16) for h in (8, hkv, hkv))
    got = tflash.flash_attention(q, k, v, causal=True)
    _within_one_bf16_ulp(got, tflash.flash_attention_plain(q, k, v, True),
                         2e-5)


def test_ssd_bf16_kernel_returns_bf16_and_an_fp32_state(cuda_device):
    x, B_, C_, dt, A, st = _ssd_inputs(2, 600, 8, 64, 64, True, 33,
                                       cuda_device)
    x = x.to(torch.bfloat16)
    y, fin = tssd.ssd(x, B_, C_, dt, A, st)
    y_p, fin_p = tssd.ssd_plain(x, B_, C_, dt, A, st)
    _within_one_bf16_ulp(y, y_p, 1e-4)
    assert fin.dtype == torch.float32
    torch.testing.assert_close(fin, fin_p, rtol=1e-4, atol=1e-4)


ARCH_FAMILIES = ("tinyllama-1.1b", "qwen1.5-0.5b", "llama4-scout-17b-a16e",
                 "mamba2-780m", "zamba2-1.2b", "musicgen-large")


def _reduced_arch(arch):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.nn.dims import compute_dims
    cfg = reduced(get_arch(arch))
    return cfg, compute_dims(cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCH_FAMILIES)
def test_card_arch_forward_matches_cpu(cuda_device, arch, dtype):
    """One reduced() forward per family through the flash path: fp32
    logits within 1e-4 of max|logits|, bf16 within the 2e-2 bound."""
    from repro_torch.launch import serve
    from repro_torch.nn import model as model_lib
    from repro_torch.nn.params import tree_map
    cfg, dims = _reduced_arch(arch)
    cpu_p = model_lib.init_params(cfg, dims,
                                  torch.Generator().manual_seed(1), "cpu")
    if dtype == torch.float32:          # as served, the bf16 tree as built
        cpu_p = tree_map(lambda a: a.float(), cpu_p)
    card_p = tree_map(lambda a: a.to(cuda_device), cpu_p)
    batch = serve.lm_prompts(cfg, dims, 2, 40,
                             torch.Generator().manual_seed(2), "cpu")
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    inp = batch.get("tokens", batch.get("embeds"))
    want = model_lib.forward(cpu_p, inp, cfg, dims, attn_impl="pallas")
    got = model_lib.forward(card_p, inp.to(cuda_device), cfg, dims,
                            attn_impl="pallas").cpu()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert got.dtype == dtype and err <= tol, err


def test_card_zamba2_prefill_launches_the_derived_kernels(cuda_device):
    """A hybrid prefill launches one ssd per Mamba-2 layer and one flash
    per application of the shared attention block; a decode step
    neither."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (StepOptions, make_decode_step,
                                          make_prefill_step)
    cfg, dims = _reduced_arch("zamba2-1.2b")
    params = serve.lm_arch_params(cfg, dims, cuda_device)
    batch = serve.lm_prompts(cfg, dims, 2, 64,
                             torch.Generator().manual_seed(3), cuda_device)
    kops.reset_launch_counts()
    logits, cache = make_prefill_step(cfg, dims, StepOptions("pallas"),
                                      s_max=65)(params, batch)
    counts = kops.launch_counts()
    assert counts["ssd"] == cfg.num_layers == 6
    assert counts["flash_attention"] == cfg.num_attn_layers() == 3
    make_decode_step(cfg, dims)(params, cache,
                                torch.argmax(logits, -1)[:, None], 64)
    assert kops.launch_counts() == counts


# ---------------------------------------------------------------------------
# training: the kernels refuse a gradient; the train step on the card
# ---------------------------------------------------------------------------


def _refusal_cases(dev):
    """Each hand-written kernel's wrapper with valid card operands: (name,
    call, the floating operands that may ask for a gradient)."""
    g = torch.Generator().manual_seed(41)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g,
                                  dtype=torch.int8).to(dev)
    f32 = lambda *s: (torch.rand(s, generator=g) + 0.5).to(dev)
    x_q, w_q, xs, ws, b = i8(8, 16), i8(16, 8), f32(8), f32(8), f32(8)
    c_x, c_w, c_ws, c_b = i8(1, 8, 8, 4), i8(3, 3, 4, 8), f32(8), f32(8)
    fx, fw = f32(1, 8, 8, 4), f32(3, 3, 4, 8)
    qx, qs = f32(16, 8), f32(8)
    q = f32(1, 32, 2, 16)
    sx, sb, sdt = f32(1, 32, 2, 8), f32(1, 32, 8), f32(1, 32, 2) * 0.1
    sa = -f32(2)
    return [
        ("int8_matmul", lambda xs, ws, b: tmm.int8_matmul(x_q, w_q, xs, ws,
                                                          b), [xs, ws, b]),
        ("conv2d_int8", lambda ws, b: tconv.conv2d_int8(c_x, c_w, ws, b),
         [c_ws, c_b]),
        ("conv2d", lambda x, w, b: tconv.conv2d(x, w, b), [fx, fw, c_b]),
        ("quantize_apply", lambda x, s: tquant.quantize_apply(x, s),
         [qx, qs]),
        ("flash_attention", lambda q, k, v: tflash.flash_attention(q, k, v),
         [q, q.clone(), q.clone()]),
        ("ssd", lambda x, b, c, dt, a: tssd.ssd(x, b, c, dt, a, chunk=16)[0],
         [sx, sb, sb.clone(), sdt, sa]),
    ]


def test_all_six_kernel_wrappers_refuse_a_gradient_on_the_card(cuda_device):
    """No wrapper returns a detached result under autograd: each raises
    for each floating operand that requires a gradient, and with none (or
    under no_grad) launches its kernel as before."""
    for name, call, operands in _refusal_cases(cuda_device):
        want = call(*operands)
        for i in range(len(operands)):
            ops_ = [o.clone().requires_grad_(j == i)
                    for j, o in enumerate(operands)]
            with pytest.raises(RuntimeError, match=f"{name}: the kernel has "
                               "no gradient"):
                call(*ops_)
            with torch.no_grad():
                got = call(*ops_)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()


def _train_twins(arch, dtype, dev, opts=None):
    """One train step of a reduced() config on the card and on the CPU
    from the same seeded state: ((loss, grads, params) per device)."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepOptions, TrainState, \
        make_loss_fn, make_train_step
    from repro_torch.nn import model as model_lib
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamW
    cfg, dims = _reduced_arch(arch)
    p0 = model_lib.init_params(cfg, dims, torch.Generator().manual_seed(5),
                               "cpu")
    p0 = tree_map(lambda a: a.to(dtype), p0)
    batch = serve.lm_prompts(cfg, dims, 2, 32,
                             torch.Generator().manual_seed(6), "cpu")
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    batch["labels"] = torch.randint(0, cfg.vocab_size, (2, 32),
                                    generator=torch.Generator().manual_seed(7))
    opts = opts or StepOptions()
    out = []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda a: a.to(d), p0)
        b = {k: v.to(d) for k, v in batch.items()}
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), p)
        loss = make_loss_fn(cfg, dims, opts)(leaves, b)
        grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                    materialize_grads=True)
        opt = AdamW(lr=1e-3)
        state, m = make_train_step(cfg, dims, opt, opts)(
            TrainState(p, opt.init(p)), b)
        out.append((float(loss), [x.float().cpu() for x in grads],
                    [x.float().cpu() for x in tree_leaves(state.params)],
                    float(m["loss"])))
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b",
                                  "llama4-scout-17b-a16e", "musicgen-large"])
def test_card_train_step_matches_cpu(cuda_device, arch):
    """fp32 (TF32 off): loss within 1e-5 relative and every grad leaf
    within 1e-4 of its max|g|; bf16: loss within 2e-2 (the MoE's router
    and expert gate products widen under autograd, ``dot_f32``)."""
    card, cpu = _train_twins(arch, torch.float32, cuda_device)
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for got, want in zip(card[1], cpu[1]):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    card, cpu = _train_twins(arch, torch.bfloat16, cuda_device)
    assert abs(card[3] - cpu[3]) <= 2e-2 * abs(cpu[3])


@pytest.mark.parametrize("arch,impl", [("mamba2-780m", "chunked"),
                                       ("zamba2-1.2b", "chunked"),
                                       ("tinyllama-1.1b", "pallas")])
def test_card_train_step_refuses_the_kernels(cuda_device, arch, impl):
    """A train step that would differentiate through the ssd or flash
    kernel on the card raises, as the reference's jax.grad through its
    Pallas kernels fails on its TPU."""
    from repro_torch.launch.steps import StepOptions
    with pytest.raises(RuntimeError, match="the kernel has no gradient"):
        _train_twins(arch, torch.float32, cuda_device,
                     StepOptions(attn_impl=impl))
