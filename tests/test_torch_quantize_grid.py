"""The ``quantize_apply`` kernel's grid (``csrc/quantize.cu``), mirrored in
numpy: the launch's sizing from the SM count and the kernel's occupancy,
each thread's column group and first row, and its walk down the rows
(the first row alone, then unrolled, then the tail). Every element is written exactly once, by threads that walk the
same number of rows give or take one, within one resident wave. Also the
wrapper's vector-width rule and its refusals, on CPU tensors.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quantize as tquant

THREADS = 256
H100_SMS = 132
# resident threads an SM keeps at the kernel's occupancy: 2048 at full
# occupancy, fewer if registers limit it
RESIDENT_PER_SM = (2048, 1536, 256)

# CNet's five weights, the LM's at zamba2-1.2b widths, then edges
SHAPES = [(18, 48), (432, 48), (432, 32), (32769, 92), (92, 1),
          (2048, 2048), (2048, 4096), (2048, 64), (4096, 2048),
          (2048, 32000), (1, 4097), (257, 3), (1, 1), (7, 1_048_576),
          (65_537, 32_768)]


def launch_plan(m, n, v, sms, resident_per_sm):
    """``launch<V, U>``: (column groups, row step, blocks)."""
    groups = n // v
    step = min(max(sms * resident_per_sm // groups, 1), m)
    turns = -(-m // step)
    step = -(-m // turns)
    blocks = -(-(groups * step) // THREADS)
    return groups, step, blocks


def thread_rows(t, m, groups, step, u):
    """The kernel's walk for thread ``t``: (first column, rows), or None
    for a thread past the last whole set of column groups."""
    row0 = t // groups
    if row0 >= step:
        return None
    rows, r = [row0], row0 + step
    while r + (u - 1) * step < m:
        rows.extend(r + k * step for k in range(u))
        r += u * step
    while r < m:
        rows.append(r)
        r += step
    return t - row0 * groups, rows


def vector_width(m, n):
    return 4 if n % 4 == 0 else 1


@pytest.mark.parametrize("resident_per_sm", RESIDENT_PER_SM)
@pytest.mark.parametrize("m,n", SHAPES)
def test_grid_takes_every_row_and_column_group_once(m, n, resident_per_sm):
    v = vector_width(m, n)
    groups, step, blocks = launch_plan(m, n, v, H100_SMS, resident_per_sm)
    t = np.arange(blocks * THREADS, dtype=np.int64)
    row0, group = t // groups, t % groups
    live = row0 < step
    # the live threads take each (column group, first row) pair once
    assert int(live.sum()) == groups * step
    pairs = np.unique(group[live] * step + row0[live])
    assert pairs.size == groups * step
    # a thread walks rows row0, row0 + step, ...: first rows below step
    # give every row of the matrix once
    assert 1 <= step <= m
    walked = -(-(m - row0[live]) // step)
    assert int(walked.sum()) == m * groups
    assert int(walked.max() - walked.min()) <= 1
    # one resident wave (a partial block more), unless the column groups
    # alone need more threads
    wave = H100_SMS * resident_per_sm
    assert blocks * THREADS < max(wave, groups) + THREADS
    # the kernel's 32-bit thread index and the grid's x extent
    assert blocks * THREADS < 2 ** 32 and blocks < 2 ** 31


@pytest.mark.parametrize("u", [4, 8])
@pytest.mark.parametrize("m,n,resident", [
    (18, 48, 2048), (92, 1, 2048), (257, 3, 256), (1, 4097, 256),
    (37, 12, 1), (101, 8, 2), (64, 64, 3)])
def test_unrolled_walk_writes_each_element_once(m, n, resident, u):
    """The whole kernel over a small matrix (few resident threads, so each
    thread takes many rows: the first alone, then unrolled, then the
    tail): the count of writes to every element is one."""
    v = vector_width(m, n)
    groups, step, blocks = launch_plan(m, n, v, 1, resident)
    writes = np.zeros((m, n), np.int64)
    for t in range(blocks * THREADS):
        walk = thread_rows(t, m, groups, step, u)
        if walk is None:
            continue
        g, rows = walk
        assert rows == list(range(rows[0], m, step))
        for r in rows:
            writes[r, g * v:(g + 1) * v] += 1
    assert (writes == 1).all()


def test_vector_width_follows_n_and_alignment():
    x = torch.zeros(4 * 48 + 4)
    q = torch.zeros(4 * 48 + 4, dtype=torch.int8)
    aligned = x[:4 * 48].view(4, 48)
    assert aligned.data_ptr() % 16 == 0
    assert tquant.vector_width(aligned, q[:4 * 48].view(4, 48)) == 4
    # a contiguous view 4 bytes into its storage, N not a multiple of 4,
    # a code array off its 4-byte word
    assert tquant.vector_width(x[1:4 * 48 + 1].view(4, 48),
                               q[:4 * 48].view(4, 48)) == 1
    assert tquant.vector_width(x[:4 * 47].view(4, 47),
                               q[:4 * 47].view(4, 47)) == 1
    assert tquant.vector_width(aligned, q[1:4 * 48 + 1].view(4, 48)) == 1
    assert tquant.vector_width(x[:4].view(4, 1), q[:4].view(4, 1)) == 1


@pytest.mark.parametrize("shape,scale_shape", [
    ((4, 3), (4,)), ((12,), (12,)), ((2, 3, 4), (4,))])
def test_quantize_apply_refuses_bad_shapes(shape, scale_shape):
    with pytest.raises(ValueError):
        tquant.quantize_apply(torch.zeros(shape), torch.ones(scale_shape))
