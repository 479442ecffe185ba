"""The rule that routes ``int8_matmul`` between its two CUDA kernels (the
tensor-core tile kernel and the split-K kernel), the route counters, and
the wrapper's refusals before anything launches. Runs on the CPU: the
refusals are reached with ``build.on_cpu`` patched to say "card" and
``build.library`` patched to fail the test if a launch is attempted."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as tops

# the LM block's dense nodes at zamba2-1.2b widths (models/lm.py:
# build_graph, ZAMBA2_1_2B): (name, K, N); per-position, so M = B x 2048
LM_DENSE = [("emb", 2048, 2048), ("q_proj", 2048, 2048),
            ("k_proj", 2048, 2048), ("v_proj", 2048, 2048),
            ("out_proj", 2048, 2048), ("ssm_in", 2048, 4096),
            ("b_proj", 2048, 64), ("c_proj", 2048, 64),
            ("dt_proj", 2048, 64), ("down_proj", 4096, 2048),
            ("head", 2048, 32000)]


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("name,k,n", LM_DENSE)
def test_lm_prefill_projections_take_the_tile_kernel(b, name, k, n):
    assert tmm.route(b * 2048, k, n) == "tile", name


def test_tuned_lm_head_takes_the_tile_kernel():
    # the autotuned head at one prompt: packed [2048, 32000] by (1024, 256)
    assert tmm.route(2048, 2048, 32000) == "tile"


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", [(32769, 92), (92, 1)])  # fc1 and head
def test_cnet_dense_layers_keep_the_split_k_kernel(m, k, n):
    assert tmm.route(m, k, n) == "splitk"


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("name,k,n", LM_DENSE)
def test_lm_decode_projections_route_by_width(m, name, k, n):
    """A decode step runs the same nodes on one row per KV slot: every
    projection over K = 2048 takes the tile kernel, down_proj (K = 4096)
    keeps split-K."""
    want = "splitk" if name == "down_proj" else "tile"
    assert tmm.route(m, k, n) == want, name


@pytest.mark.parametrize("m,k,n,want", [
    (65, 4099, 130, "tile"),           # K not a multiple of 16
    (200, 92, 1, "tile"),
    (33, 300, 130, "tile"),
    (32, 4096, 2048, "splitk"),        # the last M split-K keeps
    (65_600, 8, 32_768, "splitk"),     # K below one wgmma step
    (10 ** 6, 31, 2, "splitk"),
    (10 ** 6, 32, 2, "tile"),
    (1, 2048, 64, "tile"),             # small M: K and N decide
    (32, 2049, 64, "splitk"),
    (32, 2048, 63, "splitk"),
    (16, 8, 32000, "splitk")])
def test_route_rule_edges(m, k, n, want):
    """M, K and N decide; unaligned K (the tile kernel stages through
    byte loads there) does not."""
    assert tmm.route(m, k, n) == want


@pytest.fixture
def no_launch(monkeypatch):
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda name: pytest.fail(
        "reached the launch"))


def _operands(m, k, n):
    """[m, k] x [k, n] operands as broadcast views (no memory)."""
    return (torch.zeros((1, k), dtype=torch.int8).expand(m, k),
            torch.zeros((k, 1), dtype=torch.int8).expand(k, n),
            torch.ones(1).expand(m), torch.ones(1).expand(n))


def test_int8_matmul_refuses_more_output_tiles_than_grid_x(no_launch):
    """The tile kernel lays its 128 x 128 output tiles on gridDim.x (at
    most 2^31 - 1): a larger product is refused before anything
    launches, and before any operand is copied."""
    m = n = 2 ** 23
    with pytest.raises(ValueError, match="output tiles"):
        tmm.int8_matmul(*_operands(m, 64, n))


def test_int8_matmul_forced_split_k_keeps_its_cap(no_launch, monkeypatch):
    m = tmm.ROWS_PER_BLOCK * tmm.MAX_GRID_Z + 1
    assert tmm.route(m, 64, 2) == "tile"
    monkeypatch.setattr(tmm, "route", lambda m, k, n: "splitk")
    with pytest.raises(ValueError, match="row tiles"):
        tmm.int8_matmul(*_operands(m, 64, 2))


def test_route_counters_reset_with_the_launch_counts():
    tmm.launches_tile, tmm.launches_splitk = 3, 4
    assert tops.route_counts() == {"tile": 3, "splitk": 4}
    tops.reset_launch_counts()
    assert tops.route_counts() == {"tile": 0, "splitk": 0}


@pytest.mark.parametrize("kernel", [None, "tile", "splitk"])
def test_cpu_tensors_take_the_plain_version_on_either_route(kernel,
                                                            monkeypatch):
    """A CPU tensor takes the plain version whatever the rule says, and
    neither route counter moves."""
    if kernel is not None:
        monkeypatch.setattr(tmm, "route", lambda m, k, n: kernel)
    tops.reset_launch_counts()
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-127, 128, (40, 70), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (70, 9), generator=g, dtype=torch.int8)
    got = tmm.int8_matmul(x, w, torch.ones(40), torch.ones(9))
    want = (x.long() @ w.long()).float()
    assert torch.equal(got, want)
    assert tops.route_counts() == {"tile": 0, "splitk": 0}
    assert tops.launch_counts()["int8_matmul"] == 0
