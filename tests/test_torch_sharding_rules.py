"""PyTorch port: the sharding rules (``runtime/sharding.py``) as data,
held to the reference's on abstract meshes, with no ranks.

For every config at full size and the meshes (16, 16), (2, 16, 16), (4, 2),
(8,) and (1, 1): each parameter's fitted spec, the optimizer state's specs
for adamw, adafactor and q8adam (``make_train_state_specs``), and the
cache, SSM state, batch and batch-leaf specs equal the reference's. The
reference's shapes come from ``jax.eval_shape``, the port's from the meta
device. Then twins of ``tests/core/test_sharding_rules.py``'s six tests,
and ``fit_spec`` against the reference's over drawn shapes and specs.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models as rmodels
import repro.optim as roptim
from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_abstract_mesh as ref_amesh
from repro.runtime.sharding import ShardingRules as RefRules, fit_spec as ref_fit_spec
from repro.runtime.steps import make_train_state_specs as ref_state_specs
from repro.utils.testing import given, settings, st
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import build
from repro_torch.optim import get_optimizer
from repro_torch.runtime.sharding import ShardingRules, Spec, fit_spec
from repro_torch.runtime.steps import make_train_state_specs

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((8,), ("data",)), ((1, 1), ("data", "model"))]
OPTIMIZERS = ("adamw", "adafactor", "q8adam")


def _is_p(x):
    return isinstance(x, P)


def _ref_flat_specs(shape_tree, spec_tree) -> dict:
    paths = list(ref_flatten(shape_tree)[0])
    specs = jax.tree.leaves(spec_tree, is_leaf=_is_p)
    assert len(paths) == len(specs)
    return {p: tuple(s) for p, s in zip(paths, specs)}


@functools.lru_cache(maxsize=None)
def _port_state(arch: str, opt: str):
    model = build(get_config(arch))
    params = model.init(torch.Generator(), "meta")
    return params, get_optimizer(opt).init(params)


@pytest.mark.parametrize("arch", list_archs())
def test_state_specs_equal_reference(arch):
    """Params and optimizer state, every leaf, every mesh, all three
    optimizers; the cache, SSM state and batch specs."""
    rmodel = rmodels.build(ref_get_config(arch))
    cfg = get_config(arch)
    for shape, axes in MESHES:
        rrules = RefRules(cfg=ref_get_config(arch), mesh=ref_amesh(shape, axes))
        rules = ShardingRules(cfg, make_abstract_mesh(shape, axes))
        for opt in OPTIMIZERS:
            p_shape, o_shape, p_spec, o_spec = ref_state_specs(
                rmodel, rrules, roptim.get_optimizer(opt))
            want = {f"params/{k}": v for k, v in _ref_flat_specs(p_shape, p_spec).items()}
            want.update({f"opt/{k}": v for k, v in _ref_flat_specs(o_shape, o_spec).items()})
            got = make_train_state_specs(*_port_state(arch, opt), rules)
            assert sorted(got) == sorted(want), (arch, shape, opt)
            bad = {k: (got[k], want[k]) for k in want if tuple(got[k]) != want[k]}
            assert not bad, (arch, shape, opt, bad)
        params = _port_state(arch, "adamw")[0]
        assert rules.opt_state_specs(params) == {
            k: tuple(v) for k, v in _ref_flat_specs(
                p_shape, rrules.opt_state_specs(p_shape)).items()}
        for name in ("cache_spec", "ssm_state_spec", "batch_spec"):
            assert tuple(getattr(rules, name)()) == tuple(getattr(rrules, name)()), name
        assert rules.decode_batch_axes() == rrules.decode_batch_axes()
        for leaf in ((32, 128), (6, 8), (7,), ()):
            assert tuple(rules.batch_sharding_for(leaf)) == tuple(
                rrules.batch_sharding_for(leaf).spec), leaf


# -- twins of tests/core/test_sharding_rules.py ------------------------------------------

def test_fit_spec_drops_nondivisible():
    m1 = make_abstract_mesh((1,), ("data",))
    assert fit_spec(m1, Spec("data"), (7,)) == Spec("data")  # size-1 axis divides
    assert fit_spec(m1, Spec("nope"), (8,)) == Spec(None)
    assert fit_spec(m1, Spec("data", "data"), (4,)) == Spec("data")


def test_param_rules_cover_all_archs():
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    for arch in ("command-r-plus-104b", "arctic-480b", "zamba2-1.2b",
                 "musicgen-medium", "paligemma-3b"):
        cfg = get_config(arch, smoke=True)
        params = build(cfg).init(torch.Generator(), "meta")
        specs = ShardingRules(cfg, mesh).params_specs(params)
        assert len(specs) == len(jax.tree.leaves(
            jax.eval_shape(lambda c=ref_get_config(arch, smoke=True):
                           rmodels.build(c).init(jax.random.key(0)))))


def test_tp_rules_shard_expected_dims():
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    rules = ShardingRules(get_config("granite-8b"), mesh)
    assert rules.spec_for("blocks/attn/wq", (36, 4096, 4096))[2] == "model"
    assert rules.spec_for("blocks/attn/wo", (36, 4096, 4096))[1] == "model"
    assert rules.spec_for("embed", (49152, 4096))[0] == "model"
    moe_rules = ShardingRules(get_config("arctic-480b"), mesh)
    assert moe_rules.spec_for("blocks/moe/wi", (35, 128, 7168, 4864))[1] == "model"


def test_no_tp_means_model_axis_joins_batch():
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    rules = ShardingRules(get_config("gemma-2b"), mesh)  # tensor_parallel=False
    assert rules.model_axis is None
    assert "model" in rules.data_axes
    assert rules.batch_sharding_for((4, 128))[0] == ("data", "model")


def test_cache_spec_head_dim_fallback():
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    assert ShardingRules(get_config("command-r-plus-104b"), mesh).cache_spec()[2] == "model"
    assert ShardingRules(get_config("qwen2-0.5b"), mesh).cache_spec()[4] is None


def test_layer_axis_never_sharded():
    rules = ShardingRules(get_config("granite-8b"), make_abstract_mesh((1, 1), ("data", "model")))
    for path, shape in [("blocks/attn/wq", (36, 4096, 4096)),
                        ("blocks/mlp/wi", (36, 4096, 14336)),
                        ("blocks/moe/wi", (36, 8, 4096, 1408))]:
        assert rules.spec_for(path, shape)[0] is None


# -- fit_spec over drawn shapes and specs ----------------------------------------------

_AXES = st.sampled_from([None, "pod", "data", "model", "nope", ("pod", "data"),
                         ("data", "model"), ("pod", "data", "model")])


@settings(max_examples=200, deadline=None)
@given(mesh_i=st.integers(0, len(MESHES) - 1),
       shape=st.lists(st.integers(1, 96), min_size=0, max_size=4),
       spec=st.lists(_AXES, min_size=0, max_size=5))
def test_fit_spec_matches_reference(mesh_i, shape, spec):
    shape_, axes = MESHES[mesh_i]
    want = ref_fit_spec(ref_amesh(shape_, axes), P(*spec), tuple(shape))
    got = fit_spec(make_abstract_mesh(shape_, axes), tuple(spec), tuple(shape))
    assert tuple(got) == tuple(want)
