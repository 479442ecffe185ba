"""The port's logical-axis rules (``parallel/sharding.py``) against the
reference's, without processes: ``spec_for`` reads only ``.shape`` and
``.axis_names``, so a stand-in mesh (the reference tests' ``FakeMesh``)
serves both packages.

For every array of all ten archs at full size — params, optimizer state,
the decode caches at ``decode_32k`` and the inputs of every cell — on the
(16, 16) and (2, 16, 16) production meshes, under the mesh's rules and
``serving_rules``, the port's spec equals the reference's; plus the
counterparts of ``test_spec_for_invariants`` and
``test_serving_rules_drop_fsdp``, and the spec <-> placements mapping.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.distributed.tensor import Replicate, Shard

from repro.configs import all_archs, get_arch, shapes_for
from repro.launch import specs as j_specs
from repro.nn import model as j_model
from repro.nn.dims import compute_dims
from repro.parallel import sharding as j_sh
from repro_torch.parallel import sharding as t_sh

MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


def _arrays(cfg, dims):
    """(name, shape, logical axes) of every array of the arch's cells."""
    p_axes = j_model.param_axes(cfg, dims)
    params = j_model.abstract_model_params(cfg, dims)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    axes = jax.tree.leaves(p_axes, is_leaf=j_sh.is_logical_leaf)
    out = [(jax.tree_util.keystr(k), v.shape, a)
           for (k, v), a in zip(leaves, axes)]
    for shape in shapes_for(cfg):
        if shape.kind == "decode":
            cache = j_model.abstract_cache(cfg, dims, shape.global_batch,
                                           shape.seq_len)
            c_axes = jax.tree.leaves(
                j_model.cache_axes(cfg, dims, shape.global_batch,
                                   shape.seq_len),
                is_leaf=j_sh.is_logical_leaf)
            out += [(f"{shape.name}{jax.tree_util.keystr(k)}", v.shape, a)
                    for (k, v), a in zip(
                        jax.tree_util.tree_leaves_with_path(cache), c_axes)]
        ins = j_specs.input_specs(cfg, dims, shape)
        in_ax = j_specs.batch_axes(cfg, shape)
        out += [(f"{shape.name}/{k}", v.shape, in_ax[k])
                for k, v in ins.items()]
    return out


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_spec_for_equals_the_reference_on_production_meshes(arch):
    cfg = get_arch(arch)
    dims = compute_dims(cfg, tp=16)
    arrays = _arrays(cfg, dims)
    assert len(arrays) > 10
    n = 0
    for mesh_shape in MESHES.values():
        mesh = FakeMesh(mesh_shape)
        # the optimizer's m / v / master take the params' axes and shapes
        for rules in (j_sh.rules_for(mesh), j_sh.serving_rules(mesh)):
            t_rules = (t_sh.rules_for(mesh) if rules is j_sh.rules_for(mesh)
                       else t_sh.serving_rules(mesh))
            assert t_rules == rules
            for name, shape, axes in arrays:
                want = tuple(j_sh.spec_for(shape, axes, mesh, rules))
                got = t_sh.spec_for(shape, axes, mesh, t_rules)
                assert got == want, (name, mesh_shape, got, want)
                n += 1
    assert n == 4 * len(arrays)


def test_the_port_specs_of_a_cell_equal_the_reference_specs():
    """``launch/specs.py: shardings_for_cell`` resolves the same specs the
    reference's ``tree_shardings`` would (its trees, leaf by leaf)."""
    from repro_torch.configs import get_arch as t_arch
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch.specs import shardings_for_cell
    from repro_torch.nn.dims import compute_dims as t_dims
    from repro_torch.optim.adamw import AdamW
    mesh = FakeMesh(MESHES["single"])
    for arch in ("qwen1.5-0.5b", "zamba2-1.2b", "llama4-scout-17b-a16e"):
        cfg = t_arch(arch)
        dims = t_dims(cfg, tp=16)
        for shape in ("train_4k", "decode_32k"):
            got = shardings_for_cell(cfg, dims, SHAPES_BY_NAME[shape], mesh,
                                     AdamW())
            jcfg = get_arch(arch)
            jd = compute_dims(jcfg, tp=16)
            want = [tuple(j_sh.spec_for(v.shape, a, mesh))
                    for v, a in zip(
                        jax.tree.leaves(j_model.abstract_model_params(jcfg,
                                                                      jd)),
                        jax.tree.leaves(j_model.param_axes(jcfg, jd),
                                        is_leaf=j_sh.is_logical_leaf))]
            assert _spec_leaves(got["params"]) == want


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


MESH_SHAPES = st.sampled_from([(16, 16), (2, 16, 16), (4, 8), (2, 4, 4)])
LOGICALS = st.lists(
    st.sampled_from([None, "batch", "seq", "heads", "ffn", "vocab", "embed",
                     "expert", "kv_heads"]),
    min_size=1, max_size=4)


@settings(max_examples=200, deadline=None)
@given(MESH_SHAPES, LOGICALS,
       st.lists(st.integers(1, 4096), min_size=1, max_size=4))
def test_spec_for_invariants(mesh_shape, logical, dims):
    """1) sharded dims always divide the mesh-axis product;
       2) no mesh axis is used twice;  3) rank is preserved; and the spec is
       the reference's."""
    n = min(len(logical), len(dims))
    logical, dims = logical[:n], dims[:n]
    mesh = FakeMesh(mesh_shape)
    spec = t_sh.spec_for(dims, logical, mesh)
    assert spec == tuple(j_sh.spec_for(dims, logical, mesh))
    assert len(spec) == n
    used = []
    for dim, part in zip(dims, spec):
        prod = 1
        for a in t_sh.spec_axes(part):
            prod *= mesh.shape[a]
            used.append(a)
        assert dim % prod == 0, (dim, part, prod)
    assert len(used) == len(set(used)), f"mesh axis reused: {spec}"


def test_serving_rules_drop_fsdp():
    mesh = FakeMesh((16, 16))
    rules = t_sh.serving_rules(mesh)
    assert rules["fsdp"] == () and rules["expert_ffn"] == ()
    spec = t_sh.spec_for((4096, 4096), ("fsdp", "ffn"), mesh, rules)
    assert spec[0] is None and spec[1] == "model"


@pytest.mark.parametrize("mesh_shape,spec,want", [
    ((16, 16), ("data", "model"), [Shard(0), Shard(1)]),
    ((16, 16), (None, "model", None), [Replicate(), Shard(1)]),
    ((2, 16, 16), (("pod", "data"), None), [Shard(0), Shard(0), Replicate()]),
    ((2, 16, 16), (), [Replicate()] * 3)])
def test_placements_for(mesh_shape, spec, want):
    mesh = FakeMesh(mesh_shape)
    assert t_sh.placements_for(spec, mesh) == want
    if spec:
        shape = (64,) * len(spec)
        local = t_sh.local_shape(shape, spec, mesh)
        for n, loc, part in zip(shape, local, spec):
            k = 1
            for a in t_sh.spec_axes(part):
                k *= mesh.shape[a]
            assert loc * k == n
