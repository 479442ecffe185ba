"""csrc/int8_matmul.cu's split-K partition, mirrored on the CPU.

``splitk`` below walks the kernel's grid as it is written: each block's
weight slice staged into a shared tile (flat, or row by row, in the piece
size the kernel picks from the row stride), the 8 warps' 4-row K steps,
each lane's 4 columns read from that tile, the block's int32 sums, and
the persistent scratch that the last block of each output tile reads and
zeroes again. Unwritten shared bytes hold junk, as on the card. It holds:

* every k of every (m, n) is summed exactly once, and no copy reads
  outside the weight buffer or writes outside the tile;
* the int32 sums equal the exact product, so the kernel's epilogue (the
  plain version's) gives the plain version's output bit for bit;
* the scratch is zero again after a call, so a second call in a row,
  with no memset between, is right.

Shapes: CNet's fc1 [16, 32769] x [32769, 92] plain and prepacked (row
stride 96), its head, the LM decode step's K > 2048 product at M = 4,
ESPERTA's K = 3, N = 1, and M not a multiple of 16 in all three staging
modes (16-, 4- and 1-byte pieces).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import int8_matmul as tmm

KB, BN, MT, WARPS = (tmm.SPLITK_K_ROWS, tmm.SPLITK_COLS, tmm.ROWS_PER_BLOCK,
                     tmm.SPLITK_WARPS)


def piece(flat: bool, ldw: int) -> int:
    """The kernel's copy size for a 16-byte aligned weight buffer."""
    align = 16 if flat else ldw
    return 16 if align % 16 == 0 else 4 if align % 4 == 0 else 1


def splitk(x, wbuf, ldw, n, scratch, rng):
    """The kernel's sums for x [M, K] int8 against the [K, ldw] weight
    buffer ``wbuf`` (flat uint8), first ``n`` columns. ``scratch`` (int64,
    the kernel's int32 words) must be zero. Returns (sums [M, n], coverage
    [K, n] of the first row tile)."""
    m, k = x.shape
    kc, nt, mt = tmm.splitk_grid(m, k, n)
    flat = nt == 1 and ldw <= BN
    g = piece(flat, ldw)
    words = not flat or ldw % 4 == 0
    ss = ldw if flat else BN
    acc, done = scratch[:m * n], scratch[m * n:]
    out = np.zeros((m, n), np.int64)
    cover = np.zeros((k, n), np.int64)
    xi = x.astype(np.int64)
    for mb in range(mt):
        m0 = mb * MT
        for nb in range(nt):
            n0 = nb * BN
            cols = min(BN, n - n0)
            for kb in rng.permutation(kc):          # blocks in any order
                k0 = kb * KB
                rows = min(KB, k - k0)
                wt = rng.integers(0, 256, KB * BN).astype(np.uint8)  # junk
                if flat:
                    lo, ln = k0 * ldw, rows * ldw
                    assert lo % g == 0 and lo + ln <= wbuf.size
                    wt[:ln] = wbuf[lo:lo + ln]
                else:
                    run = -(-cols // g) * g
                    assert n0 % g == 0 and n0 + run <= ldw and run <= BN
                    for r in range(rows):
                        lo = (k0 + r) * ldw + n0
                        wt[r * BN:r * BN + run] = wbuf[lo:lo + run]
                xt = np.zeros((MT, KB), np.int64)
                mr = min(MT, m - m0)
                xt[:mr, :rows] = xi[m0:m0 + mr, k0:k0 + rows]
                part = np.zeros((MT, BN), np.int64)
                c_idx = np.arange(BN)
                for warp in range(WARPS):
                    for kk in range(4 * warp, rows, 4 * WARPS):
                        idx = ((kk + np.arange(4))[:, None] * ss
                               + c_idx[None, :])          # [4 k, 128 cols]
                        live = c_idx < cols if not words else (
                            4 * (c_idx // 4) < cols)
                        assert idx[:, live].max() < KB * BN
                        wb = np.where(live, wt[np.minimum(idx, KB * BN - 1)]
                                      .view(np.int8), 0).astype(np.int64)
                        part += xt[:, kk:kk + 4] @ wb
                        if mb == 0:
                            ks = k0 + kk + np.arange(4)
                            ok = ks < k0 + rows
                            cover[ks[ok][:, None],
                                  np.arange(n0, n0 + cols)[None]] += 1
                tile = part[:mr, :cols]
                if kc == 1:                       # no scratch
                    out[m0:m0 + mr, n0:n0 + cols] = tile
                    continue
                view = acc.reshape(m, n)[m0:m0 + mr, n0:n0 + cols]
                view += tile
                assert np.abs(view).max() < 2 ** 31
                t = mb * nt + nb
                done[t] += 1
                if done[t] == kc:                 # the last block
                    out[m0:m0 + mr, n0:n0 + cols] = view
                    view[...] = 0
                    done[t] = 0
    return out, cover


def _operands(seed, m, k, n, ldw, kp=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    buf = np.zeros((kp or k, ldw), np.int8)
    buf[:k, :n] = w
    return rng, x, w, buf.view(np.uint8).reshape(-1)


# (M, K, N, row stride, packed rows): fc1 and the head plain and
# prepacked; the decode step's down_proj; ESPERTA; ragged M in the
# 16-byte, 4-byte and 1-byte staging modes; K at one and two blocks
SHAPES = [(16, 32769, 92, 92, None), (16, 32769, 92, 96, 33792),
          (16, 92, 1, 1, None), (16, 92, 1, 8, 96),
          (4, 4096, 2048, 2048, None), (5, 3, 1, 1, None),
          (33, 300, 144, 144, None), (31, 600, 132, 132, None),
          (33, 300, 130, 130, None), (17, 256, 64, 64, None),
          (3, 257, 7, 7, None)]


@pytest.mark.parametrize("m,k,n,ldw,kp", SHAPES)
def test_split_k_partition_sums_each_k_once_and_exactly(m, k, n, ldw, kp):
    rng, x, w, buf = _operands(m + k + n + ldw, m, k, n, ldw, kp)
    scratch = np.zeros(max(1, tmm.splitk_scratch_words(m, k, n)), np.int64)
    want = x.astype(np.int64) @ w.astype(np.int64)
    for call in range(2):                 # the second call, no memset
        got, cover = splitk(x, buf, ldw, n, scratch, rng)
        np.testing.assert_array_equal(got, want, err_msg=f"call {call}")
        np.testing.assert_array_equal(cover, np.ones_like(cover))
        assert not scratch.any()


@pytest.mark.parametrize("m,k,n,words", [
    (16, 32769, 92, 16 * 92 + 1), (16, 92, 1, 0), (4, 4096, 2048, 8192 + 16),
    (5, 3, 1, 0), (33, 300, 130, 33 * 130 + 6), (1, 256, 9, 0),
    (1, 257, 9, 9 + 1)])
def test_split_k_scratch_words(m, k, n, words):
    assert tmm.splitk_scratch_words(m, k, n) == words


def test_split_k_scratch_is_kept_zeroed_once_and_grown(monkeypatch):
    monkeypatch.setattr(tmm, "_SPLITK_SCRATCH", {})
    dev = torch.device("cpu")
    assert tmm._splitk_scratch(dev, 0) is None
    first = tmm._splitk_scratch(dev, 100)
    assert first.dtype == torch.int32 and first.numel() == 100
    assert not first.any()
    assert tmm._splitk_scratch(dev, 40) is first      # reused, not zeroed
    bigger = tmm._splitk_scratch(dev, 101)
    assert bigger is not first and bigger.numel() == 101
    assert not bigger.any()


@pytest.mark.parametrize("m,k,n", [(16, 32769, 92), (4, 4096, 2048),
                                   (16, 92, 1), (5, 3, 1)])
def test_split_k_shapes_route_to_split_k(m, k, n):
    """The shapes the mirror holds are the ones the rule sends here."""
    assert tmm.route(m, k, n) == "splitk"
