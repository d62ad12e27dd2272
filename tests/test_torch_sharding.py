"""The port's sharding rules, mesh specs and ``FLShardPlan`` against the JAX
package's, with no devices: every rules function entry for entry against
JAX's ``PartitionSpec``s for every arch of ``list_archs()`` at full size
(the port's trees on the meta device, JAX's from ``abstract_params`` /
``abstract_cache``), on the 1x1, 2x2, 16x16 and 2x16x16 meshes."""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config
from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch.mesh import parse_mesh_spec as j_parse_mesh_spec
from repro.models import abstract_cache, abstract_params
from repro.sharding import fl as jfl
from repro.sharding import rules as jrules
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.models.decode import init_cache
from repro_torch.models.init import init_params
from repro_torch.sharding import rules
from repro_torch.sharding.fl import FLShardPlan
from repro_torch.utils.tree import tree_flatten_with_keys

MESHES = ("1x1", "2x2", "16x16", "2x16x16")
JP = jax.sharding.PartitionSpec


def _keyed(tree, is_spec=False):
    if is_spec:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))
        return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]
    return [(k, tuple(s)) for k, s in tree_flatten_with_keys(tree)[0]]


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(port params on meta, JAX abstract params) of ``arch``."""
    return (init_params(0, get_config(arch), device="meta"),
            abstract_params(j_get_config(arch)))


def _cache_shape(cfg, shape):
    return shape.seq_len + (cfg.n_patches if cfg.frontend == "vision_stub"
                            else 0)


@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_jax_entry_for_entry(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tp, jp = _trees(arch)
    assert [k for k, _ in tree_flatten_with_keys(tp)[0]] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jp)[0]]
    for spec in MESHES:
        mc, jmc = parse_mesh_spec(spec), j_parse_mesh_spec(spec)
        for train in (True, False):
            assert _keyed(rules.param_specs(cfg, tp, mc, train=train)) == \
                _keyed(jrules.param_specs(jcfg, jp, jmc, train=train), True)
        assert _keyed(rules.fsdp_only_specs(cfg, tp, mc)) == \
            _keyed(jrules.fsdp_only_specs(jcfg, jp, jmc), True)
        for name, shape in SHAPES.items():
            jshape = J_SHAPES[name]
            assert tuple(rules.token_spec(shape, mc)) == \
                tuple(jrules.token_spec(jshape, jmc))
            got = rules.batch_specs(cfg, shape, mc)
            want = jrules.batch_specs(jcfg, jshape, jmc)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
            if shape.kind != "decode":
                continue
            S = _cache_shape(cfg, shape)
            tc = init_cache(cfg, shape.global_batch, S, device="meta")
            jc = abstract_cache(jcfg, shape.global_batch, S)
            assert _keyed(rules.cache_specs(cfg, tc, shape, mc)) == \
                _keyed(jrules.cache_specs(jcfg, jc, jshape, jmc), True)


def test_mask_specs_and_spec_normalization():
    idx = {"a": torch.zeros(3, dtype=torch.int64),
           "b": [torch.zeros(0, dtype=torch.int64)]}
    mc, jmc = MeshConfig(2, 2), JMeshConfig(2, 2)
    assert _keyed(rules.mask_specs(idx, mc)) == \
        _keyed(jrules.mask_specs(jax.tree.map(lambda t: t.numpy(), idx),
                                 jmc), True)
    for entries in [(("data",), None), (("pod", "data"), "model"), ()]:
        assert tuple(rules.Spec(*entries)) == tuple(JP(*entries))
    assert rules.Spec(("data",), None) == ("data", None)
    assert repr(rules.Spec(None)) == "Spec(None)"


def test_shapes_equal_jax():
    assert SHAPES.keys() == J_SHAPES.keys()
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == \
            (j.seq_len, j.global_batch, j.kind)
        assert get_shape(name) is s
        r, jr = s.reduced(), j.reduced()
        assert (r.name, r.seq_len, r.global_batch) == \
            (jr.name, jr.seq_len, jr.global_batch)


@pytest.mark.parametrize("spec", ["1x1", "2x2", "4x1", "2x16x16", "single",
                                  "multi"])
def test_parse_mesh_spec_equals_jax(spec):
    mc, jmc = parse_mesh_spec(spec), j_parse_mesh_spec(spec)
    assert (mc.data, mc.model, mc.pods) == (jmc.data, jmc.model, jmc.pods)
    assert (mc.shape, mc.axis_names, mc.batch_axes, mc.n_devices) == \
        (jmc.shape, jmc.axis_names, jmc.batch_axes, jmc.n_devices)


@pytest.mark.parametrize("bad", ["2", "2x", "axb", "1x2x3x4", ""])
def test_parse_mesh_spec_errors_as_jax(bad):
    with pytest.raises(ValueError) as e:
        parse_mesh_spec(bad)
    with pytest.raises(ValueError) as je:
        j_parse_mesh_spec(bad)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("rule", ["fsdp", "replicate", "tp"])
@pytest.mark.parametrize("spec", ["2x2", "2x16x16"])
def test_plan_properties_equal_jax(rule, spec):
    """FLShardPlan's spec logic, which needs no mesh (as JAX's
    test_fl_plan_specs_without_devices)."""
    plan = FLShardPlan(None, parse_mesh_spec(spec), rule)
    jplan = jfl.FLShardPlan.__new__(jfl.FLShardPlan)
    for k, v in (("mesh", None), ("mesh_cfg", j_parse_mesh_spec(spec)),
                 ("rule", rule)):
        object.__setattr__(jplan, k, v)
    assert plan.batch_axes == jplan.batch_axes and plan.dp == jplan.dp
    for n, nd in ((plan.dp * 2, 3), (plan.dp + 1, 2), (1, 4)):
        assert tuple(plan.client_batch_spec(n, nd)) == \
            tuple(jplan.client_batch_spec(n, nd))
    tp, jp = _trees("qwen3-4b")
    assert _keyed(plan.param_specs(tp)) == \
        _keyed(jplan.param_specs(jp), True)
    with pytest.raises(ValueError):
        FLShardPlan(None, parse_mesh_spec(spec), rule="bogus")


def test_to_placements_nests_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    P = rules.Spec
    assert rules.to_placements(P(("pod", "data", "model"), None), Mesh) == \
        [Shard(0)] * 3
    assert rules.to_placements(P(None, "model"), Mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    assert rules.to_placements(P(("pod", "data"), "model"), Mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="order"):
        rules.to_placements(P(("model", "data")), Mesh)
