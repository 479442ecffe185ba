"""The chunk-parallel decomposition of csrc/ssd.cu, mirrored on the CPU,
and the LM prefill that caches its final state.

``chunked`` below computes the SSD scan as the kernel's three launches do:
every chunk's own state contribution and last cum (the state kernel), a
pass over the chunks that carries the state (the pass kernel), then each
chunk's y from its diagonal part and the state entering it (the scan
kernel), with the cumsum taken in the kernel's block-scan order and the
products either exact in fp32 or in the kernel's 3xTF32 split (emulated
as in tests/test_torch_tf32x3.py). It is held at 1e-4 (the SSD
tolerance, the reference's kernel-vs-chunked bound) against ``ssd_plain``
and against the JAX reference's ``ops.ssd``. A second mirror walks the
scan kernel's grid (strips heavier first, tiles, warps, the column groups
each warp skips in the diagonal tile) and shows that it covers each pair
j <= i of each chunk exactly once.

The LM commit caches the SSD kernel's final state: a prefill never runs
the per-position recurrence, and the cached state is ``ssd_plain``'s
final state on the block's own SSD inputs, tuned and untuned.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro_torch.core import lm as tlm_core
from repro_torch.core.engine import Engine
from repro_torch.core.lm import LMEngine
from repro_torch.kernels import ssd as tssd
from repro_torch.models import lm as tlm
from test_torch_tf32x3 import mm_3xtf32_trunc

TOL = 1e-4
TILE = 64               # csrc/ssd.cu: kT, a staged column tile
SCAN_WARPS = 8          # kScanWarps: the scan kernel's warps, 16 rows each
STRIP = 16 * SCAN_WARPS
CUM_WARPS = 4           # kCumWarps: the block scan's warps
SCAN = 32 * CUM_WARPS   # positions per pass of the block scan


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).float()


def block_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis in csrc/ssd.cu's order: passes
    of 128, a Hillis-Steele scan inside each warp of 32, then the carry
    and the totals of the warps before, each add rounded to fp32."""
    v = v.float()
    out = torch.empty_like(v)
    carry = torch.zeros(v.shape[:-1])
    for base in range(0, v.shape[-1], SCAN):
        seg = v[..., base:base + SCAN]
        pad = SCAN - seg.shape[-1]
        w = torch.nn.functional.pad(seg, (0, pad)).reshape(
            v.shape[:-1] + (CUM_WARPS, 32))
        for o in (1, 2, 4, 8, 16):
            w = torch.cat([w[..., :o], w[..., :-o] + w[..., o:]], dim=-1)
        pre, total = carry, carry
        scanned = []
        for k in range(CUM_WARPS):
            scanned.append(pre[..., None] + w[..., k, :])
            pre = pre + w[..., k, 31]
        for k in range(CUM_WARPS):
            total = total + w[..., k, 31]
        out[..., base:base + SCAN] = torch.cat(scanned, -1)[
            ..., :seg.shape[-1]]
        carry = total
    return out


def chunked(x, B_, C_, dt, A, init=None, chunk=256, mm=mm_fp32):
    """The kernel's decomposition in tensor ops. Returns (y, final)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = tssd.chunk_size(s, chunk)
    nc = s // q
    xc = x.reshape(b, nc, q, h, p)
    bc, cc = B_.reshape(b, nc, q, n), C_.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    cum = block_cumsum((dtc * A).transpose(2, 3)).transpose(2, 3)
    cq = cum[:, :, -1]                                     # [b,nc,h]
    # (1) each chunk's own contribution: ((x w)^T B), w = exp(cq - cum) dt
    w = torch.exp(cq[:, :, None] - cum) * dtc              # [b,nc,q,h]
    xw = (xc * w[..., None]).permute(0, 1, 3, 4, 2)        # [b,nc,h,p,q]
    own = mm(xw, bc[:, :, None])                           # [b,nc,h,p,n]
    # (2) the pass: the state entering each chunk, and the final state
    state = (torch.zeros((b, h, p, n)) if init is None else init.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cq[:, c])[..., None, None] + own[:, c]
    st_in = torch.stack(entering, 1)                       # [b,nc,h,p,n]
    # (3) y = exp(cum) (C state^T) + the diagonal part M x
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,i,j,h]
    L = torch.where(tri[..., None], torch.exp(li), 0.0)
    G = mm(cc, bc.transpose(-1, -2))                       # [b,nc,i,j]
    M = G[..., None] * L * dtc[:, :, None]                 # [b,nc,i,j,h]
    y_diag = mm(M.permute(0, 1, 4, 2, 3), xc.permute(0, 1, 3, 2, 4))
    y_in = mm(cc[:, :, None], st_in.transpose(-1, -2))     # [b,nc,h,q,p]
    y = torch.exp(cum).permute(0, 1, 3, 2)[..., None] * y_in + y_diag
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), state


def _inputs(seed, b, s, h, p, n, init):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, n)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.05).astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, h)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if init else None)
    return x, B_, C_, dt, A, st


# (S, chunk, P, N): a divisor chunk; S not a multiple of the chunk (the
# divisor fallback: 250, and 37 itself); chunks of more than one 64-row
# strip and more than one 128-position scan pass; P and N below their
# pads (64, and 64 or 128); N in the 128 instantiation
CASES = [(64, 16, 8, 16), (1000, 256, 8, 16), (37, 256, 5, 7),
         (512, 256, 16, 32), (300, 256, 8, 72)]
_REFERENCE = {}


@pytest.mark.parametrize("s,chunk,p,n", CASES)
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("mm", [mm_fp32, mm_3xtf32_trunc],
                         ids=["fp32", "3xtf32"])
def test_chunk_parallel_decomposition_matches_plain_and_reference(
        s, chunk, p, n, init, mm):
    x, B_, C_, dt, A, st = _inputs(s + chunk + p + n, 1, s, 2, p, n, init)
    tx = [torch.from_numpy(a) for a in (x, B_, C_, dt, A)]
    tst = None if st is None else torch.from_numpy(st)
    y, fin = chunked(*tx, tst, chunk=chunk, mm=mm)
    y_p, fin_p = tssd.ssd_plain(*tx, tst, chunk)
    torch.testing.assert_close(y, y_p, rtol=TOL, atol=TOL)
    torch.testing.assert_close(fin, fin_p, rtol=TOL, atol=TOL)
    key = (s, chunk, p, n, init)
    if key not in _REFERENCE:        # one reference run for both products
        _REFERENCE[key] = jops.ssd(
            *map(jnp.asarray, (x, B_, C_, dt, A)),
            None if st is None else jnp.asarray(st), chunk=chunk)
    yj, fj = _REFERENCE[key]
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fj), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("length", [1, 31, 32, 100, 128, 129, 256, 250])
def test_block_cumsum_prefix_is_the_whole_scans(length):
    """The scan kernel scans only the prefix its strip needs; each cum it
    gets equals the state kernel's over the whole chunk, bit for bit, and
    both are within the tolerance of torch's cumsum."""
    v = torch.from_numpy(np.random.default_rng(length).uniform(
        -0.8, -0.02, (3, 256)).astype(np.float32))
    whole = block_cumsum(v)
    assert torch.equal(block_cumsum(v[:, :length]), whole[:, :length])
    torch.testing.assert_close(whole, torch.cumsum(v, -1), rtol=TOL,
                               atol=TOL)


def scan_coverage(q: int, nc: int) -> np.ndarray:
    """How often ssd_scan_kernel's grid forms M[i, j] for each chunk c,
    row i < Q and column j < Q (counting the work it does, masked or
    not, by warp and 8-column group)."""
    n_strips = -(-q // STRIP)
    seen = np.zeros((nc, q, q), np.int64)
    for bx in range(n_strips * nc):
        si, c = n_strips - 1 - bx // nc, bx % nc
        i0 = si * STRIP
        n_tiles = (min(q, i0 + STRIP) - 1) // TILE + 1
        for tj in range(n_tiles):
            j0 = tj * TILE
            for warp in range(SCAN_WARPS):
                w_last = i0 + 16 * warp + 15
                if i0 + 16 * warp >= q or j0 > w_last:
                    continue
                ng = min(8, (w_last - j0) // 8 + 1)
                rows = np.arange(i0 + 16 * warp, w_last + 1)
                cols = np.arange(j0, j0 + 8 * ng)
                ii, jj = np.meshgrid(rows, cols, indexing="ij")
                keep = (ii < q) & (jj <= ii)       # the kernel's mask
                np.add.at(seen, (c, ii[keep], jj[keep]), 1)
    return seen


@pytest.mark.parametrize("q,nc", [(256, 3), (250, 4), (37, 2), (64, 1),
                                  (512, 2), (100, 1)])
def test_scan_grid_covers_each_lower_pair_once(q, nc):
    seen = scan_coverage(q, nc)
    want = np.tril(np.ones((q, q), np.int64))[None].repeat(nc, 0)
    np.testing.assert_array_equal(seen, want)


# ---------------------------------------------------------------------------
# the LM prefill caches the kernel's final state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_lm():
    cfg = tlm.DEFAULT_CONFIG
    e = Engine(tlm.build_graph(cfg), tlm.init_params(0, cfg), device="cpu")
    e.calibrate([tlm.synthetic_input(np.random.default_rng(1), cfg)
                 for _ in range(4)])
    return cfg, e


@pytest.mark.parametrize("backend", ["accel", "flex"])
def test_prefill_never_runs_the_per_position_step(small_lm, monkeypatch,
                                                  backend):
    cfg, e = small_lm
    lm = LMEngine(e, backend, n_slots=2, max_new_tokens=4)

    def forbidden(*a, **kw):
        raise AssertionError("_ssd_step ran in a prefill")

    monkeypatch.setattr(tlm_core, "_ssd_step", forbidden)
    x = tlm.synthetic_batch(np.random.default_rng(3), 2, cfg)["x"]
    res = lm.prefill(x, np.array([0, 1], np.int32))
    assert np.isfinite(res.hidden).all()
    with pytest.raises(AssertionError, match="_ssd_step"):
        lm.decode_step(res.hidden, np.array([0, 1], np.int32))


@pytest.mark.parametrize("autotune", [False, True])
def test_prefill_caches_the_kernels_final_state(small_lm, autotune):
    """The cached state is ssd_plain's final state over the SSD node's
    own inputs at the rung's chunk (the tuned one with --autotune)."""
    cfg, base = small_lm
    e = Engine(base.graph, base.params, device="cpu", autotune=autotune)
    e.share_calibration(base)
    lm = LMEngine(e, "accel", n_slots=3, max_new_tokens=4)
    x = tlm.synthetic_batch(np.random.default_rng(5), 2, cfg)["x"]
    slots = np.array([2, 0], np.int32)
    lm.prefill(x, slots)
    plan = lm.plan
    outs = e.run_batch({"x": x}, "accel")
    (name,) = lm._ssd_nodes
    node = plan.graph.nodes[name]
    cfg_t = plan._tuning.get(2, {}).get(name) if autotune else None
    chunk = (cfg_t.config.chunk if cfg_t is not None and cfg_t.config.chunk
             else node.attrs.get("chunk", 256))
    # the final state does not depend on C (which is no graph output)
    xh, bp, dt = (outs[node.inputs[i]].float() for i in (0, 1, 3))
    _, want = tssd.ssd_plain(xh, bp, torch.zeros_like(bp), dt,
                             plan.params[name]["A"], None, chunk)
    got = lm.caches[name]["state"][torch.as_tensor(slots, dtype=torch.long)]
    assert torch.equal(got, want)
    assert torch.equal(outs[f"{name}/final_state"], want)
    assert not lm.caches[name]["state"][1].any()      # untouched slot
