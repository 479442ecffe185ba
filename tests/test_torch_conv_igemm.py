"""The index map of the port's implicit-GEMM convolution kernels, emulated
on the CPU against the JAX reference.

``csrc/igemm.cuh`` (with ``csrc/conv2d_int8.cu`` and ``csrc/conv2d_f32.cu``)
computes a convolution as a GEMM: M is a 4 x 32 tile of output pixels, N
the block's output channels (in passes of up to 64), K the filter's own
[KH, KW, Cin] order zero-padded to the MMA depth (32 for int8, 8 for
TF32). A is read in place from the staged input patch when Cin fills
whole K half-steps (16 int8, 8 fp32), else through im2col rows built in
shared memory from a patch whose rows were copied as the 16-byte-aligned
chunks covering their in-image bytes. Outputs are staged in shared memory
at the same offset mod 16 as their global address and written as aligned
16-byte chunks.

This file mirrors those functions line for line in numpy (the layout, the
patch staging of both modes, the offset tables, the A and filter tiles,
the output staging and its store), runs whole convolutions through the
mirror, and holds the result against the reference's Pallas kernels (run
in interpret mode, as the reference's own tests run them on the CPU):

* int8: the int32 GEMM over the kernel's K order, through the port's
  ``kernels/epilogue.py``, equals the reference's ``conv2d_int8`` bit for
  bit (with ``tests/test_torch_kernels.py``'s two stated exceptions), for
  both grids (whole Cout and channel blocks) and pre-padded inputs;
* fp32: the GEMM in 3xTF32 with the kernel's truncation split
  (``tests/test_torch_tf32x3.py``) holds the reference's ``conv2d`` within
  1e-4 (its own kernel tolerance).

Patch bytes the copies leave unwritten and output-staging bytes are filled
with a marker first, so a read of either would show. The shapes are CNet's
three convs, its tuned stem and the VAE stem, cut to two images and
narrow maps, plus ragged Cin/Cout and stride-2 cases. A change to the
``.cu`` index math belongs here first.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels.epilogue import (apply_epilogue, dequant_bias, f32,
                                          reciprocal_f32)
from test_torch_kernels import _check as check_against_reference
from test_torch_tf32x3 import mm_3xtf32_trunc

ROWS, COLS = 4, 32
PIX = ROWS * COLS
WARPS = PIX // 16
NCHUNK = 64
SMEM_LIMIT = 232448
MARK = 0xA5


def round_up(x, m):
    return -(-x // m) * m


def conflict_free(nbytes):
    return nbytes + 16 if nbytes % 32 == 0 else nbytes


def layout(cin, bc, kh, kw, stride, elt, depth, half, out_elt=4, msub=1,
           inplace=None):
    """igemm::layout (``inplace`` forces a mode, for the mode test)."""
    L = SimpleNamespace(msub=msub)
    L.inplace = cin % half == 0 if inplace is None else inplace
    L.run = round_up(kw * cin * elt, 4) // elt
    L.K = kh * L.run
    L.Kp = round_up(L.K, depth)
    L.ph = (ROWS * msub - 1) * stride + kh
    L.pw = (COLS - 1) * stride + kw
    L.pix_stride = conflict_free(cin * elt)
    L.row_stride = round_up(L.pw * cin * elt, 16) + 32
    L.patch_bytes = (round_up(L.ph * L.pw * L.pix_stride, 16) if L.inplace
                     else L.ph * L.row_stride)
    L.steps = L.Kp // half if L.inplace else L.Kp
    L.a_stride = conflict_free(L.Kp * elt)
    L.nc8 = round_up(bc, 8)
    L.w_stride = conflict_free(L.Kp * elt)
    L.nchunk = min(L.nc8, NCHUNK)
    out_px = round_up(out_elt * L.nchunk, 16) + 16
    out_seg = round_up(out_elt * 16 * L.nchunk, 16) + 16
    L.out_bytes = max(PIX * out_px, WARPS * out_seg)
    fixed = (round_up(L.nc8, 16) * L.w_stride + 8 * L.nc8
             + round_up((4 if L.inplace else 8) * L.steps, 16)
             + round_up(12 * L.ph, 16) + 32 * -(-L.nc8 // NCHUNK) + 16
             + (0 if L.inplace or elt == 4 else PIX * L.a_stride)
             + L.out_bytes)
    L.slots = 3 if fixed + 3 * L.patch_bytes <= SMEM_LIMIT else 2
    L.total = fixed + L.slots * L.patch_bytes
    return L


def int8_layout(cin, bc, kh, kw, stride, requant=True, msub=1, **kw_):
    return layout(cin, bc, kh, kw, stride, 1, 32, 16, 1 if requant else 4,
                  msub, **kw_)


def f32_layout(cin, bc, kh, kw, stride, msub=1, **kw_):
    return layout(cin, bc, kh, kw, stride, 4, 8, 4, 4, msub, **kw_)


def tiles(s, msub):
    rows = ROWS * msub
    tw, th = -(-s.Wo // COLS), -(-s.Ho // rows)
    for i in range(s.B * th * tw):
        b, rem = divmod(i, th * tw)
        yield SimpleNamespace(b=b, ho0=(rem // tw) * rows,
                              wo0=(rem % tw) * COLS)


def row_shift(s, t, hi, pb):
    """The low 4 bits of patch column 0's byte offset (mod 2^32)."""
    wi0 = t.wo0 * s.stride - s.pad_left
    return (((t.b * s.H + hi) * s.W + wi0) * pb) & 0xFFFFFFFF & 15


def stage_patch(xb, s, L, t, pb):
    """igemm::stage_patch into one ring slot (unwritten bytes = MARK)."""
    slot = np.full(L.patch_bytes, MARK, np.uint8)
    hi0 = t.ho0 * s.stride - s.pad_top
    wi0 = t.wo0 * s.stride - s.pad_left
    if L.inplace:
        for pr in range(L.ph):
            for pc in range(L.pw):
                hi, wi = hi0 + pr, wi0 + pc
                d = (pr * L.pw + pc) * L.pix_stride
                if 0 <= hi < s.H and 0 <= wi < s.W:
                    g = ((t.b * s.H + hi) * s.W + wi) * pb
                    slot[d:d + pb] = xb[g:g + pb]
                else:
                    slot[d:d + pb] = 0
        return slot
    wl, wh = max(wi0, 0), min(wi0 + L.pw, s.W)
    if wl >= wh:
        return slot
    total = xb.size
    for pr in range(L.ph):
        hi = hi0 + pr
        if not 0 <= hi < s.H:
            continue
        row = (t.b * s.H + hi) * s.W
        g0 = (row + wi0) * pb
        base = g0 - (g0 & 15)
        ga, gb = (row + wl) * pb, (row + wh) * pb
        for k in range(L.row_stride // 16):
            c = ga - (ga & 15) + 16 * k
            if c >= gb:
                continue
            n = min(16, total - c)
            d = pr * L.row_stride + (c - base)
            assert c % 16 == 0 and d % 16 == 0
            assert c - base + 16 <= L.row_stride       # the row's capacity
            slot[d:d + 16] = np.concatenate(
                [xb[c:c + n], np.zeros(16 - n, np.uint8)])
    return slot


def k_index(L, cin, kw, kk):
    """igemm::k_index: (valid, r, c, ci) of K index kk."""
    r, j = divmod(kk, L.run)
    c, ci = divmod(j, cin)
    return kk < L.K and c < kw, r, c, ci


def build_table(s, L, elt, half):
    """igemm::build_table: in place, the patch offset of each 16-byte A
    row's (tap, first channel) or -1 past K; im2col, r | c << 16 (r =
    0xffff for padding) for each k, then each k's byte offset in a patch
    row's run."""
    tab = [0] * (L.steps if L.inplace else 2 * L.Kp)
    for h in range(L.steps):
        if L.inplace:
            kk = h * half
            _, r, c, ci = k_index(L, s.Cin, s.KW, kk)
            tab[h] = ((r * L.pw + c) * L.pix_stride + ci * elt
                      if kk < L.K else -1)
        else:
            valid, r, c, ci = k_index(L, s.Cin, s.KW, h)
            tab[h] = r | (c << 16) if valid else 0xFFFF
            tab[L.Kp + h] = (c * s.Cin + ci) * elt if valid else 0
    return tab


def weight_row(L, cin, kw, kk):
    """igemm::weight_row: the HWIO weight row of K index kk, or -1."""
    valid, r, c, ci = k_index(L, cin, kw, kk)
    return (r * kw + c) * cin + ci if valid else -1


def tile_rows(s, L, t, pb):
    """igemm::tile_rows: each patch row's slot offset, -1 outside."""
    rows = []
    for pr in range(L.ph):
        hi = t.ho0 * s.stride - s.pad_top + pr
        rows.append(pr * L.row_stride + row_shift(s, t, hi, pb)
                    if 0 <= hi < s.H else -1)
    return rows


def a_tile(slot, tab, s, L, t, dtype, half, dr, rows):
    """Sub-tile t's [PIX, Kp] A operand as the MMAs read it: in place
    through the table (a negative entry reads the zero row), or the im2col
    rows build_im2col writes. ``dr`` is the sub-tile's first patch row,
    ``rows`` the tile's patch-row offsets (im2col)."""
    elt = np.dtype(dtype).itemsize
    pb = s.Cin * elt
    A = np.zeros((PIX, L.Kp), dtype)
    rows = None if L.inplace else rows[dr:]
    wi0 = t.wo0 * s.stride - s.pad_left
    pclo, pchi = -wi0, s.W - wi0
    for p in range(PIX):
        rr, cc = divmod(p, COLS)
        if L.inplace:
            base = ((dr + rr * s.stride) * L.pw + cc * s.stride) * \
                L.pix_stride
            for h, o in enumerate(tab):
                if o >= 0:
                    A[p, h * half:(h + 1) * half] = slot[
                        base + o:base + o + half * elt].view(dtype)
            continue
        prb, pcb = rr * s.stride, cc * s.stride
        hi0 = t.ho0 * s.stride - s.pad_top
        inside = (wi0 >= 0 and wi0 + L.pw <= s.W and hi0 >= 0
                  and hi0 + (ROWS - 1) * s.stride + s.KH <= s.H)
        if inside and elt == 1:
            # each word: 4 bytes of one filter row's run, read unaligned
            # from the patch row and masked past the run's kwc values
            for kw in range(L.Kp // 4):
                rw, jb = divmod(4 * kw, L.run)
                if rw >= s.KH:
                    continue
                src = pcb * pb + rows[prb + rw] + jb
                assert src + 4 <= slot.size
                n = min(4, max(s.KW * s.Cin - jb, 0))
                A[p, 4 * kw:4 * kw + n] = slot[src:src + n].view(dtype)
            continue
        for kk in range(L.Kp):
            rc = tab[kk]
            r, pc = rc & 0xFFFF, pcb + (rc >> 16)
            if r == 0xFFFF or not pclo <= pc < pchi:
                continue
            ro = rows[prb + r]
            if ro < 0:
                continue
            o = pcb * pb + ro + tab[L.Kp + kk]
            A[p, kk] = slot[o:o + elt].view(dtype)[0]
    return A


def filter_tile(w, co0, bc, L):
    """The block's staged filter [nc8, Kp]: K-major per channel, zeros
    past K, bc and the weight's channel count."""
    kh, kw, cin, cw = w.shape
    w2 = w.reshape(-1, cw)
    Wt = np.zeros((L.nc8, L.Kp), w.dtype)
    for kk in range(L.Kp):
        wr = weight_row(L, cin, kw, kk)
        if wr >= 0:
            n = min(bc, cw - co0)
            Wt[:n, kk] = w2[wr, co0:co0 + n]
    return Wt


def out_offset(s, t, cout, o, p):
    """igemm::out_offset: pixel p's first staged byte, -1 past Ho/Wo; a
    rowseg run is a warp's 16 pixels."""
    rr, cc = divmod(p, COLS)
    ho, wo = t.ho0 + rr, t.wo0 + cc
    if ho >= s.Ho or wo >= s.Wo:
        return -1
    if o.rowseg:
        c0 = cc & ~15
        u = ((t.b * s.Ho + ho) * s.Wo + t.wo0 + c0) * cout * o.elt
        return (p // 16) * o.run + (u & 15) + (cc - c0) * cout * o.elt
    u = (((t.b * s.Ho + ho) * s.Wo + wo) * cout + o.co) * o.elt
    return p * o.run + (u & 15)


def out_pass(cout, co, ncv, nchunk, elt):
    rowseg = co == 0 and ncv == cout
    run = (round_up(elt * 16 * nchunk, 16) + 16 if rowseg
           else round_up(elt * nchunk, 16) + 16)
    aligned = (cout * elt) % 16 == 0 and (co * elt) % 16 == 0
    per_run = ((16 * cout if rowseg else ncv) * elt + 15) // 16 + (
        not aligned)
    return SimpleNamespace(co=co, ncv=ncv, elt=elt, rowseg=rowseg, run=run,
                           per_run=per_run)


def store_pass(out, sm, s, t, cout, o, warp, written):
    """igemm::store_pass for one warp's runs: aligned 16-byte chunks
    whole, ragged ends by byte; ``written`` counts the writes of every
    output byte."""
    nrun = 1 if o.rowseg else 16
    for i in range(nrun * o.per_run):
        q, k = divmod(i, o.per_run)
        r = warp if o.rowseg else 16 * warp + q
        p = 16 * warp if o.rowseg else r
        ho, wo = t.ho0 + p // COLS, t.wo0 + p % COLS
        if ho >= s.Ho or wo >= s.Wo:
            continue
        pix = (t.b * s.Ho + ho) * s.Wo + wo
        gs = (pix * cout + o.co) * o.elt
        vcols = min(s.Wo - wo, 16)
        ln = (vcols * cout if o.rowseg else o.ncv) * o.elt
        end = gs + ln
        c = gs - (gs & 15) + 16 * k
        if c >= end:
            continue
        frm = r * o.run + (c - (gs - (gs & 15)))
        assert frm % 16 == 0 and frm + 16 <= sm.size
        lo, hi = max(c, gs), min(c + 16, end)
        if lo == c and hi == c + 16:
            out[c:c + 16] = sm[frm:frm + 16]
        else:
            out[lo:hi] = sm[frm + lo - c:frm + hi - c]
        written[lo:hi] += 1


def run_tiles(x, w, s, L, cout, bc, elt_out, half, dtype, gemm, epilogue):
    """The kernel's walk: every channel block, every tile of msub 4-row
    sub-tiles (one staged patch), every sub-tile, every channel pass;
    ``gemm(A, Wt)`` -> [PIX, n] and ``epilogue(acc, co0 + n0, n)`` ->
    values to store (numpy). Returns the output bytes."""
    ncb = -(-cout // bc)
    out = np.full(s.B * s.Ho * s.Wo * cout * elt_out, 0xEE, np.uint8)
    written = np.zeros(out.size, np.int32)
    xb = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    elt = np.dtype(dtype).itemsize
    tab = build_table(s, L, elt, half)
    for cb in range(ncb):
        co0 = cb * bc
        Wt = filter_tile(w, co0, bc, L)
        for tt in tiles(s, L.msub):
            slot = stage_patch(xb, s, L, tt, s.Cin * elt)
            rows = None if L.inplace else tile_rows(s, L, tt, s.Cin * elt)
            for m in range(L.msub):
                t = SimpleNamespace(b=tt.b, ho0=tt.ho0 + ROWS * m,
                                    wo0=tt.wo0)
                if t.ho0 >= s.Ho:
                    break
                A = a_tile(slot, tab, s, L, t, dtype, half,
                           ROWS * m * s.stride, rows)
                for n0 in range(0, L.nc8, NCHUNK):
                    nt = min(8, (L.nc8 - n0) // 8)
                    ncv = min(NCHUNK, bc - n0, cout - co0 - n0)
                    if ncv <= 0:
                        break
                    acc = gemm(A, Wt[n0:n0 + 8 * nt])
                    vals = epilogue(acc[:, :ncv], co0 + n0, ncv)
                    o = out_pass(cout, co0 + n0, ncv, L.nchunk, elt_out)
                    sm = np.full(L.out_bytes, MARK, np.uint8)
                    vb = np.ascontiguousarray(vals).view(np.uint8).reshape(
                        PIX, ncv * elt_out)
                    for p in range(PIX):
                        off = out_offset(s, t, cout, o, p)
                        if off >= 0:
                            sm[off:off + ncv * elt_out] = vb[p]
                    for warp in range(WARPS):
                        store_pass(out, sm, s, t, cout, o, warp, written)
    assert (written == 1).all(), "an output byte was written 0 or 2+ times"
    return out


def emulate_conv2d_int8(x, w, ws, bias, *, x_scale, stride, padding, act,
                        requant_scale, cout_per_block=0, cout=None,
                        pre_padded=False, in_hw=None, rows_per_block=8,
                        msub=1, inplace=None):
    """The int8 kernel's result, by the mirror (numpy in, numpy out)."""
    b = x.shape[0]
    kh, kw_, cin, cw = w.shape
    cout = cw if cout is None else cout
    hw = in_hw if pre_padded else x.shape[1:3]
    g = tconv.conv_geometry(int(hw[0]), int(hw[1]), kh, kw_, stride, padding,
                            rows_per_block)
    pads = (0, 0) if pre_padded else (g.pad_top, g.pad_left)
    s = SimpleNamespace(B=b, H=x.shape[1], W=x.shape[2], Cin=cin, KH=kh,
                        KW=kw_, stride=stride, pad_top=pads[0],
                        pad_left=pads[1], Ho=g.h_out, Wo=g.w_out)
    bc = cout_per_block if cout_per_block else cout
    L = int8_layout(cin, bc, kh, kw_, stride, requant_scale is not None,
                    msub, inplace=inplace)
    deq = torch.from_numpy(ws[:cout]).float() * f32(x_scale)
    bias_t = None if bias is None else torch.from_numpy(bias[:cout]).float()

    def gemm(A, Wt):            # int32 sums, exact in any order
        return A.astype(np.int64) @ Wt.astype(np.int64).T

    def epilogue(acc, co, n):
        assert np.abs(acc).max(initial=0) < 2 ** 31
        v = dequant_bias(torch.from_numpy(acc.astype(np.int32)),
                         deq[co:co + n],
                         None if bias_t is None else bias_t[co:co + n])
        return apply_epilogue(v, act, requant_scale).numpy()

    elt_out = 1 if requant_scale is not None else 4
    out = run_tiles(x, w, s, L, cout, bc, elt_out, 16, np.int8, gemm,
                    epilogue)
    dt = np.int8 if requant_scale is not None else np.float32
    return out.view(dt).reshape(b, g.h_out, g.w_out, cout)


def emulate_conv2d_f32(x, w, bias, *, stride, padding, relu, msub=1):
    """The fp32 kernel's result, by the mirror: 3xTF32 with the kernel's
    truncation split, bias add and relu in fp32."""
    b = x.shape[0]
    kh, kw_, cin, cout = w.shape
    g = tconv.conv_geometry(x.shape[1], x.shape[2], kh, kw_, stride, padding)
    s = SimpleNamespace(B=b, H=x.shape[1], W=x.shape[2], Cin=cin, KH=kh,
                        KW=kw_, stride=stride, pad_top=g.pad_top,
                        pad_left=g.pad_left, Ho=g.h_out, Wo=g.w_out)
    bc = min(round_up(cout, 8), 64)
    L = f32_layout(cin, bc, kh, kw_, stride, msub)

    def gemm(A, Wt):
        return mm_3xtf32_trunc(torch.from_numpy(A),
                               torch.from_numpy(np.ascontiguousarray(Wt.T)))

    def epilogue(acc, co, n):
        v = acc
        if bias is not None:
            v = v + torch.from_numpy(bias[co:co + n])
        if relu:
            v = torch.clamp_min(v, 0.0)
        return v.float().numpy()

    out = run_tiles(x, w, s, L, cout, bc, 4, 4, np.float32, gemm, epilogue)
    return out.view(np.float32).reshape(b, g.h_out, g.w_out, cout)


def _int8_case(b, h, w, cin, cout, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    ws = (rng.random(cout) * 0.01 + 1e-4).astype(np.float32)
    bb = rng.standard_normal(cout).astype(np.float32) if bias else None
    return x, wq, ws, bb


def _reference_int8(x, wq, ws, bb, **kw):
    j = jops.conv2d_int8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                         None if bb is None else jnp.asarray(bb), **kw)
    return np.asarray(j)


# (B, H, W, Cin, Cout, stride, padding, act, requant, msub): CNet's stem,
# act1 and act2 cut to two images and narrow maps (H, W not multiples of
# the tile), then ragged Cin/Cout and stride 2; msub the 4-row sub-tiles
# of a tile (1, 2 or 4, as the wrapper picks them)
INT8_CASES = [
    (2, 10, 40, 2, 48, 1, "SAME", "relu", 0.02, 2),       # stem: im2col
    (2, 6, 36, 48, 48, 1, "SAME", "relu", 0.0163, 1),     # act1: in place
    (2, 8, 8, 48, 32, 1, "SAME", "relu", None, 4),        # act2: f32 out
    (2, 9, 11, 5, 7, 2, "SAME", None, None, 2),
    (1, 10, 9, 4, 3, 2, "VALID", "relu", 0.05, 1),
    (1, 7, 13, 20, 9, 1, "SAME", "relu", 0.05, 1),        # K 180 -> 192
    (1, 5, 34, 64, 12, 1, "SAME", None, 0.05, 2),
    (1, 6, 9, 16, 70, 1, "SAME", "sigmoid", None, 1),     # two passes
    # maps wide and tall enough for sub-tiles whose patch lies inside the
    # image (the word-at-a-time im2col path)
    (1, 12, 100, 2, 16, 1, "SAME", "relu", 0.05, 1),
    (1, 20, 100, 3, 8, 1, "SAME", "relu", 0.05, 4),
    (1, 20, 150, 5, 7, 2, "SAME", None, None, 2),
]


@pytest.mark.parametrize(
    "b,h,w,cin,cout,stride,padding,act,requant,msub", INT8_CASES)
def test_int8_igemm_order_matches_reference_bit_for_bit(b, h, w, cin, cout,
                                                         stride, padding, act,
                                                         requant, msub):
    """Bit for bit, with tests/test_torch_kernels.py's two stated
    exceptions (sigmoid's exp; the few elements where the reference's
    backend leaves the bias add unfused). The mirror equals the port's
    plain version, the kernel's contract (sigmoid to 1e-6: PyTorch's own
    exp differs by an ulp between tensor sizes)."""
    x, wq, ws, bb = _int8_case(b, h, w, cin, cout, h * 7 + w + cin)
    kw = dict(x_scale=0.0377, stride=stride, padding=padding, act=act,
              requant_scale=requant)
    got = emulate_conv2d_int8(x, wq, ws, bb, msub=msub, **kw)
    plain = tconv.conv2d_int8_plain(*(torch.from_numpy(v)
                                      for v in (x, wq, ws, bb)), **kw)
    if act == "sigmoid":     # torch's exp differs by an ulp across sizes
        np.testing.assert_allclose(got, plain.numpy(), rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, plain.numpy())
    want = _reference_int8(x, wq, ws, bb, **kw)
    acc = emulate_conv2d_int8(x, wq, np.ones(cout, np.float32), None,
                              x_scale=1.0, stride=stride, padding=padding,
                              act=None, requant_scale=None)
    check_against_reference(want, got, act, requant,
                            (acc, ws * np.float32(0.0377), bb))


@pytest.mark.parametrize("b,h,w,cin,cout,bc,rows,pre_padded,msub", [
    (2, 16, 16, 2, 48, 16, 16, True, 4),     # CNet's tuned stem, cut
    (1, 9, 7, 3, 12, 8, 3, False, 2),        # bc does not divide Cout
    (1, 8, 8, 128, 40, 16, 8, True, 1),      # in place, several blocks
])
def test_int8_igemm_channel_blocks_match_reference(b, h, w, cin, cout, bc,
                                                   rows, pre_padded, msub):
    x, wq, ws, bb = _int8_case(b, h, w, cin, cout, cin + cout)
    kw = dict(x_scale=0.02, stride=1, padding="SAME", act="relu",
              requant_scale=0.05, rows_per_block=rows)
    want = _reference_int8(x, wq, ws, bb, **kw)
    extra = {}
    if pre_padded:
        # the arena's layout: channels padded to whole blocks with neutral
        # scale/bias, the input staged at plan time
        pad_c = -(-cout // bc) * bc - cout
        wq = np.pad(wq, ((0, 0), (0, 0), (0, 0), (0, pad_c)))
        ws = np.pad(ws, (0, pad_c), constant_values=1.0)
        bb = np.pad(bb, (0, pad_c))
        g = tconv.conv_geometry(h, w, 3, 3, 1, "SAME", rows)
        x = tconv.pad_input(torch.from_numpy(x), g).numpy()
        extra = dict(cout=cout, pre_padded=True, in_hw=(h, w))
    got = emulate_conv2d_int8(x, wq, ws, bb, cout_per_block=bc, msub=msub,
                              **kw, **extra)
    np.testing.assert_array_equal(got, want)


def test_int8_in_place_and_im2col_read_the_same_a():
    """For a Cin that fills whole half-steps both A modes give the same
    operand, so the mode is a choice of speed only."""
    x, wq, ws, bb = _int8_case(1, 5, 33, 32, 8, 11)
    kw = dict(x_scale=0.02, stride=1, padding="SAME", act=None,
              requant_scale=None)
    a = emulate_conv2d_int8(x, wq, ws, bb, inplace=True, **kw)
    b = emulate_conv2d_int8(x, wq, ws, bb, inplace=False, **kw)
    np.testing.assert_array_equal(a, b)


def test_int8_layouts_fit_and_refuse_as_the_wrapper_expects():
    """CNet's shapes fit a block; a whole 3x3x128 -> 512 filter does not
    (the wrapper refuses it and channel blocks of 64 fit); strides are
    conflict-free (16 mod 32 bytes)."""
    for cin, bc in ((2, 48), (48, 48), (48, 32), (2, 16), (128, 64)):
        L = int8_layout(cin, bc, 3, 3, 1)
        assert L.total <= SMEM_LIMIT, (cin, bc, L.total)
        assert L.w_stride % 32 == 16 and L.a_stride % 32 == 16
        assert L.inplace == (cin % 16 == 0)
    assert int8_layout(128, 512, 3, 3, 1).total > SMEM_LIMIT
    assert int8_layout(48, 48, 3, 3, 1).Kp == 448
    assert int8_layout(2, 48, 3, 3, 1).Kp == 32
    assert int8_layout(2, 48, 3, 3, 1).K == 24       # runs of 6 -> 8 bytes
    assert int8_layout(3, 8, 3, 3, 1).K == 36        # runs of 9 -> 12


# (B, H, W, Cin, Cout, stride, padding, msub): the VAE stem and CNet's
# fp32 stem cut to two images, an in-place Cin and a 5x5 VALID case
F32_CASES = [
    (2, 16, 40, 3, 8, 2, "SAME", 2),      # VAE stem: K 27 -> 32
    (2, 8, 36, 2, 48, 1, "SAME", 1),      # CNet's stem in fp32: 18 -> 24
    (1, 7, 9, 16, 12, 1, "SAME", 4),      # in place
    (1, 12, 20, 4, 16, 2, "VALID", 1),
]


@pytest.mark.parametrize("b,h,w,cin,cout,stride,padding,msub", F32_CASES)
def test_f32_igemm_3xtf32_holds_reference_tolerance(b, h, w, cin, cout,
                                                    stride, padding, msub):
    rng = np.random.default_rng(h * 31 + w)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(bias), stride=stride,
                                  padding=padding, relu=True))
    got = emulate_conv2d_f32(x, wt, bias, stride=stride, padding=padding,
                             relu=True, msub=msub)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_requant_reciprocal_is_the_wrappers():
    """The mirror's requantize is the epilogue the wrapper passes the
    kernel: rint(v * f32(1 / s))."""
    v = torch.tensor([0.5 * 0.02, 1.5 * 0.02, -2.5 * 0.02, 9.0])
    got = apply_epilogue(v, None, 0.02)
    want = torch.clamp(torch.round(v * reciprocal_f32(0.02)), -127, 127)
    assert torch.equal(got, want.to(torch.int8))


def _fastdiv(n, d):
    """igemm::FastDiv: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1,
    n / d = (umulhi(n, m) + n) >> l, with 32-bit unsigned arithmetic."""
    lg = (d - 1).bit_length() if d > 1 else 0
    m = ((1 << 32) * ((1 << lg) - d) // d + 1) & 0xFFFFFFFF
    return (((n * m) >> 32) + n) >> lg


@pytest.mark.parametrize("d", [1, 2, 3, 7, 32, 34, 65, 97, 1024, 8192,
                               65535, 2 ** 30 + 3])
def test_fastdiv_matches_integer_division(d):
    """The multiply-high division the tile walk uses is exact for every
    dividend below 2^31 (edges and a random sample)."""
    rng = np.random.default_rng(d)
    ns = [0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - d]
    ns += [int(v) for v in rng.integers(0, 2 ** 31, 2000)]
    for n in ns:
        if n >= 0:
            assert _fastdiv(n, d) == n // d, (n, d)


# the VAE's five stride-2 3x3 int8 convs (Cin, Cout); they run at B=16 on
# maps of 128x256, 64x128, 32x64, 16x32 and 8x16
VAE_CONVS = ((3, 8), (8, 32), (32, 96), (96, 144), (144, 144))


def _vae_smem(cin):
    return lambda bc: int8_layout(cin, bc, 3, 3, 2).total


@pytest.mark.parametrize("cin,cout", VAE_CONVS)
def test_whole_cout_fit_picks_the_largest_block_that_fits(cin, cout):
    """The wrapper's repair for a whole-Cout filter slice that does not
    fit one block: the largest channel block of 8k that does. The VAE's
    96 -> 144 and 144 -> 144 slices do not fit whole (their filter rows
    alone are 126,720 and 191,232 B); their blocks are 96 and 32."""
    smem_of = _vae_smem(cin)
    fits_whole = smem_of(cout) <= SMEM_LIMIT
    assert fits_whole == (cout < 144)
    if fits_whole:
        return
    bc = tconv.fit_channel_block(cout, smem_of)
    assert bc == {96: 96, 144: 32}[cin]
    assert bc % 8 == 0 and 0 < bc < cout and smem_of(bc) <= SMEM_LIMIT
    assert all(smem_of(c) > SMEM_LIMIT for c in range(bc + 8, cout, 8))


def test_fit_gives_up_when_no_block_fits():
    assert tconv.fit_channel_block(8, _vae_smem(144)) == 0
    assert tconv.fit_channel_block(64, lambda bc: SMEM_LIMIT + 1) == 0
    assert tconv.fit_channel_block(64, lambda bc: SMEM_LIMIT) == 56


def test_wrapper_runs_the_fitted_grid_and_counts_it_whole_cout(monkeypatch):
    """For 144 -> 144, stride 2, the wrapper launches the channel-blocked
    grid with the fitted block (32) and counts the launch as
    ``conv2d_int8``, as the whole-Cout call it serves; a filter slice that
    fits is launched whole. The launch is stubbed: the library is not
    built here, and the smem query is the mirror."""
    from repro_torch.kernels import build
    seen = []

    def launch(*args):
        seen.append(args[18])               # bc: 0 runs the whole grid
        return 0

    lib = SimpleNamespace(conv2d_int8=launch)
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    monkeypatch.setattr(tconv, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tconv, "smem_bytes", lambda cin, bc, kh, kw, st,
                        rq=True, msub=1: int8_layout(cin, bc, kh, kw, st,
                                                     rq, msub).total)
    monkeypatch.setattr(tconv, "launches", 0)
    monkeypatch.setattr(tconv, "launches_cout_blocks", 0)
    for (cin, cout), hw in zip(VAE_CONVS[2:], ((32, 64), (16, 32), (8, 16))):
        x = torch.zeros((16,) + hw + (cin,), dtype=torch.int8)
        w = torch.zeros((3, 3, cin, cout), dtype=torch.int8)
        out = tconv.conv2d_int8(x, w, torch.ones(cout), torch.zeros(cout),
                                x_scale=0.02, stride=2, act="relu",
                                requant_scale=0.05)
        assert out.shape == (16, hw[0] // 2, hw[1] // 2, cout)
    assert seen == [0, 96, 32]
    assert (tconv.launches, tconv.launches_cout_blocks) == (3, 0)


@pytest.mark.parametrize("cin,cout,bc", [(96, 144, 96), (144, 144, 32)])
def test_fitted_block_grid_matches_reference(cin, cout, bc):
    """The fitted channel-blocked grid at the VAE's two wide convs (one
    image, 8x16 and 6x10 maps, stride 2) equals the reference's
    whole-Cout kernel bit for bit."""
    for b, h, w in ((1, 8, 16), (1, 6, 10)):
        x, wq, ws, bb = _int8_case(b, h, w, cin, cout, cin + h)
        kw = dict(x_scale=0.0301, stride=2, padding="SAME", act="relu",
                  requant_scale=0.0421)
        want = _reference_int8(x, wq, ws, bb, **kw)
        got = emulate_conv2d_int8(x, wq, ws, bb, cout_per_block=bc, **kw)
        np.testing.assert_array_equal(got, want)


def test_sub_tiles_rule():
    """The wrapper's pick of 4-row sub-tiles per tile: the most whose
    block fits three to an SM while at least four tiles per SM remain
    (132 SMs: an H100 SXM)."""
    small, big = (lambda m: 10_000 * m), (lambda m: 60_000 + 20_000 * m)
    assert tconv.sub_tiles(16, 256, 256, 132, small) == 4   # CNet's stem
    assert tconv.sub_tiles(16, 128, 128, 132, big) == 1     # act1: smem
    assert tconv.sub_tiles(16, 64, 128, 132, small) == 1    # VAE: too few
    assert tconv.sub_tiles(16, 128, 128, 132, small) == 2
    assert tconv.sub_tiles(1, 4, 4, 132, small) == 1


def test_requantize_code_equals_rint_clamp():
    """csrc/conv2d_int8.cu's requantize_code (clamp to [-127, 127], then
    add 1.5 * 2^23 and keep the low byte) equals common.cuh's requantize
    (rint, then clamp) on every float32 path: ties, the clamp bounds,
    -0, infinities and NaN."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(20000) * 80).astype(np.float32),
        np.arange(-130, 130, 0.5, dtype=np.float32),      # every tie
        np.array([-0.0, np.inf, -np.inf, np.nan, 126.5, -126.5, 127.49,
                  -127.5, 3e38, -3e38], np.float32)])
    with np.errstate(invalid="ignore"):
        want = np.clip(np.nan_to_num(np.rint(x), nan=-127.0), -127, 127)
        y = np.minimum(np.maximum(x, np.float32(-127)), np.float32(127))
        y = np.where(np.isnan(x), np.float32(-127), y)    # fmaxf drops NaN
    t = (y + np.float32(12582912.0)).astype(np.float32)
    got = (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(got, want.astype(np.int8))
