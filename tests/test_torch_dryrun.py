"""The port's dry-run (``launch/dryrun.py``, ``launch/group_probe.py``) on a
fake process group of 256 / 512 ranks, held against the reference's
layouts.

Three subprocesses, started together, run three cells as rank 0 of the
production mesh — a
``train_4k`` cell of qwen1.5-0.5b on ``single``, a ``prefill_32k`` cell of
zamba2-1.2b on ``single`` and a ``decode_32k`` cell of llama4-scout with
the a2a dispatch on ``multi`` — each in full, as one group, and with no
group at all (``rest``). The tests check:

* the per-rank state bytes equal the sum of the local shard sizes the
  reference's ``spec_for`` gives the same trees (exact);
* full = n_groups x group + rest in FLOPs (exact: the port loops its
  groups, so the full run counts each);
* every collective kind the layouts imply carries bytes.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax

from repro.configs import get_arch, shapes_for
from repro.launch.specs import abstract_train_state, state_axes
from repro.nn import model as j_model
from repro.nn.dims import compute_dims
from repro.optim.adamw import AdamW
from repro.parallel.sharding import MULTI_POD_RULES, SINGLE_POD_RULES, spec_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {
    "qwen": ("qwen1.5-0.5b", "train_4k", "single", {}),
    "zamba2": ("zamba2-1.2b", "prefill_32k", "single", {}),
    "scout": ("llama4-scout-17b-a16e", "decode_32k", "multi",
              {"moe_impl": "a2a"}),
}

RUN = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.nn.model import group_layout
    name = sys.argv[2]
    arch, shape, mesh, over = {cells!r}[name]
    _, p, tail = group_layout(get_arch(arch))
    rest = dict(over, layers=tail)            # no group, the tail kept
    out = {{g: dryrun.run_cell(arch, shape, mesh, granularity=g,
                               overrides=over,
                               track_memory=name == "zamba2" and g == "full")
           for g in ("full", "group")}}
    out["rest"] = dryrun.run_cell(arch, shape, mesh, overrides=rest,
                                  track_memory=False)
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's records, the three cells' subprocesses run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    code = RUN.format(src=os.path.join(ROOT, "src"), cells=CELLS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"{name}.json"), name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for name in CELLS}
    out = {}
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log[-3000:]
            out[name] = json.loads((tmp / f"{name}.json").read_text())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


class FakeMesh:
    def __init__(self, kind):
        self.axis_names = (("pod", "data", "model") if kind == "multi"
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if kind == "multi" else (16, 16)))


def _local_bytes(tree, axes, mesh, rules) -> int:
    """Sum over the leaves of the local block's bytes under the
    reference's ``spec_for``."""
    total = 0
    leaves = jax.tree.leaves(tree)
    ax = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(ax)
    for leaf, lg in zip(leaves, ax):
        spec = spec_for(leaf.shape, lg, mesh, rules)
        n = 1
        for part in spec:
            for a in (() if part is None else
                      part if isinstance(part, tuple) else (part,)):
                n *= mesh.shape[a]
        total += math.prod(leaf.shape) // n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("name", CELLS)
def test_state_bytes_are_the_reference_layouts_local_shards(cells, name):
    arch, shape_name, kind, over = CELLS[name]
    cfg = get_arch(arch)
    if over.get("moe_impl"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_impl=over["moe_impl"]))
    mesh = FakeMesh(kind)
    rules = MULTI_POD_RULES if kind == "multi" else SINGLE_POD_RULES
    dims = compute_dims(cfg, tp=16)
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    p_axes, _ = state_axes(cfg, dims)
    params, opt = abstract_train_state(cfg, dims, AdamW(lr=1e-4))
    got = cells[name]["full"]["state_bytes"]
    assert got["params"] == _local_bytes(params, p_axes, mesh, rules)
    if shape.kind == "train":
        want = sum(_local_bytes(getattr(opt, f), p_axes, mesh, rules)
                   for f in ("m", "v", "master")) + 4     # + the int32 step
        assert got["opt"] == want
    if shape.kind == "decode":
        cache = j_model.abstract_cache(cfg, dims, shape.global_batch,
                                       shape.seq_len)
        axes = j_model.cache_axes(cfg, dims, shape.global_batch,
                                  shape.seq_len)
        assert got["cache"] == _local_bytes(cache, axes, mesh, rules)


@pytest.mark.parametrize("name", CELLS)
def test_full_flops_are_groups_plus_the_rest(cells, name):
    from repro_torch.configs import get_arch as t_arch
    from repro_torch.nn.model import group_layout
    n_groups, _, _ = group_layout(t_arch(CELLS[name][0]))
    c = cells[name]
    assert c["group"]["flops"] > 0
    assert c["full"]["flops"] == (n_groups * c["group"]["flops"]
                                  + c["rest"]["flops"])


@pytest.mark.parametrize("name,kinds", [
    ("qwen", ("all-gather", "reduce-scatter", "all-reduce")),
    ("zamba2", ("all-gather", "reduce-scatter")),
    ("scout", ("all-gather", "all-to-all", "all-reduce"))])
def test_collectives_the_layouts_imply_carry_bytes(cells, name, kinds):
    coll = cells[name]["full"]["collectives"]
    for kind in kinds:
        assert coll.get(kind, 0) > 0, (kind, coll)
    assert cells[name]["full"]["mesh_shape"] == FakeMesh(
        CELLS[name][2]).shape


def test_memory_tracker_records_a_peak(cells):
    assert cells["zamba2"]["full"]["peak_act_bytes"] > 0
