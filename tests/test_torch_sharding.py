"""The port's logical-axis sharding rules (``repro_torch.sharding``)
against the reference's (``repro.sharding.rules``), on the CPU.

* The reference's eight pure ``spec_for`` / override / priority cases
  (tests/test_sharding.py) run on the port; the port's spec tuple equals
  ``tuple(PartitionSpec)`` of the reference's.
* A seeded sweep of the divisibility invariant of tests/test_property.py
  (which needs hypothesis): every sharded dim divides its axes, no axis
  is used twice, and the spec equals the reference's.
* Per architecture, the param paths, shapes and logical axes, the cache
  entries and their axes, and each input shape's batch and its axes
  equal the reference's; ``fed_params_axes`` equals the reference's.
* DTensor placements, ``constrain`` and the ambient mesh outside a mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.fed import fed_step as jfed_step  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.core.fed import fed_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self._shape = shape

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def both(shape, names, mesh):
    """The port's spec, after checking it equals the reference's."""
    got = rules.spec_for(shape, names, mesh)
    assert got == tuple(jrules.spec_for(shape, names, FakeMesh(mesh)))
    return got


# ------------------------------------------ tests/test_sharding.py's cases
def test_basic_param_spec():
    # llama3 wq: embed over data, heads over model
    assert both((16384, 128, 128), ("embed", "heads", "head_dim"),
                SINGLE) == tuple(P("data", "model"))


def test_divisibility_fallback():
    # qwen1.5: 20 heads don't divide 16 -> head_dim takes model
    assert both((2560, 20, 128), ("embed", "heads", "head_dim"),
                SINGLE) == tuple(P("data", None, "model"))


def test_multi_axis_batch():
    assert both((256, 4096), ("act_batch", "act_seq"), MULTI) == \
        tuple(P(("pod", "data")))
    # single-pod mesh: pod dropped
    assert both((256, 4096), ("act_batch", "act_seq"), SINGLE) == \
        tuple(P("data"))


def test_multi_axis_prefix_drop():
    # batch 16 divides data(16) but not pod*data(32): pod dropped
    assert both((16, 128), ("act_batch", None), MULTI) == tuple(P("data"))


def test_priority_kv_heads_over_seq():
    # musicgen cache: kv=32 divides model -> seq stays unsharded
    assert both((128, 32768, 32, 64),
                ("act_batch", "act_cache_seq", "act_kv_heads", None),
                SINGLE) == tuple(P("data", None, "model"))
    # llama3 cache: kv=8 fails -> seq takes model
    assert both((128, 32768, 8, 128),
                ("act_batch", "act_cache_seq", "act_kv_heads", None),
                SINGLE) == tuple(P("data", "model"))


def test_no_axis_reuse():
    assert both((512, 512), ("mlp", "act_mlp"), SINGLE) == tuple(P("model"))


def test_rule_overrides():
    assert both((128, 1), ("act_batch", None), SINGLE) == tuple(P("data"))
    with rules.rule_overrides(act_batch=None), \
            jrules.rule_overrides(act_batch=None):
        assert both((128, 1), ("act_batch", None), SINGLE) == tuple(P())
    assert both((128, 1), ("act_batch", None), SINGLE) == tuple(P("data"))


def test_priority_names_are_rules():
    assert rules.PRIORITY_NAMES == jrules.PRIORITY_NAMES
    assert rules.DEFAULT_RULES == jrules.DEFAULT_RULES
    for n in rules.PRIORITY_NAMES:
        assert n in rules.DEFAULT_RULES


# ------------------------------------- test_property.py's invariant, swept
NAME_POOL = [None, "embed", "vocab", "heads", "kv_heads", "mlp", "act_batch",
             "act_seq", "act_heads", "act_mlp", "experts", "head_dim",
             "act_cache_seq"]


@pytest.mark.parametrize("seed", range(6))
def test_spec_for_always_divisible(seed):
    """Whatever the shape, every sharded dim divides its axis product and
    no axis serves two dims: 100 seeded draws of 1-4 dims in 1..4096
    (half of them multiples of 16), on the multi-pod mesh."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        n = int(rng.integers(1, 5))
        dims = tuple(int(d) * (16 if rng.random() < 0.5 else 1)
                     for d in rng.integers(1, 257 if seed % 2 else 4097, n))
        names = tuple(NAME_POOL[i] for i in rng.integers(0, len(NAME_POOL),
                                                         n))
        spec = both(dims, names, MULTI)
        used = []
        for d, entry in zip(dims, spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert not set(axes) & set(used), "axis reused across dims"
            used += axes
            assert d % int(np.prod([MULTI[a] for a in axes])) == 0


# ------------------------------------------------- the models' logical axes
ARCHS = sorted(JREGISTRY)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference(arch):
    jspecs, jaxes = JModel(JREGISTRY[arch]).abstract_params()
    model = Model(get_config(arch))
    specs, axes = model.abstract_params(), model.param_axes()
    assert list(specs) == list(jspecs)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert {k: _dtype_name(v.dtype) for k, v in specs.items()} == \
        {k: _dtype_name(v.dtype) for k, v in jspecs.items()}
    assert axes == {k: tuple(v) for k, v in jaxes.items()}
    assert all(v.device.type == "meta" for v in specs.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_axes_equal_the_reference(arch):
    jmodel, model = JModel(JREGISTRY[arch]), Model(get_config(arch))
    jcache = jmodel.init_cache(4, 64, abstract=True)
    cache = model.init_cache(4, 64, device="meta")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert {k: _dtype_name(v.dtype) for k, v in cache.items()} == \
        {k: _dtype_name(v.dtype) for k, v in jcache.items()}
    assert model.cache_axes() == jmodel.cache_axes()
    for shape in INPUT_SHAPES.values():
        jbatch = jshapes.batch_specs(JREGISTRY[arch], shape)
        batch = shapes.batch_specs(get_config(arch), shape)
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in batch.items()} == \
            {k: (tuple(v.shape), _dtype_name(v.dtype))
             for k, v in jbatch.items()}
        assert shapes.batch_axes(batch) == jshapes.batch_axes(jbatch)


def test_fed_params_axes_equal_the_reference():
    _, jaxes = JModel(JREGISTRY["qwen1.5-4b"]).abstract_params()
    axes = Model(get_config("qwen1.5-4b")).param_axes()
    want = jfed_step.fed_params_axes(dict(jaxes))
    assert fed_step.fed_params_axes(axes) == want
    assert all(v[0] == "fed_node" for v in want.values())
    # the node axis shards over 'pod' on the multi-pod mesh
    assert both((2, 40, 2560, 6912), want["stack/0/attn/mlp/w_in"],
                MULTI)[0] == "pod"


# ------------------------------------------------------ placements, mesh
def test_sharding_for_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert rules.sharding_for((256, 4096), ("act_batch", None), MULTI) == \
        (Shard(0), Shard(0), Replicate())
    assert rules.sharding_for((2560, 20, 128),
                              ("embed", "heads", "head_dim"), SINGLE) == \
        (Shard(0), Shard(2))
    assert rules.sharding_for((3, 5), ("embed", "mlp"), SINGLE) == \
        (Replicate(), Replicate())


def test_local_shape_divides_by_the_spec():
    spec = both((256, 4096, 32), ("act_batch", None, "act_heads"), MULTI)
    assert rules.local_shape((256, 4096, 32), spec, MULTI) == (8, 4096, 2)


def test_constrain_outside_and_on_one_rank():
    x = torch.ones(4, 8)
    assert rules.current_mesh() is None
    assert rules.constrain(x, "act_batch", None) is x
    assert rules.constrain(x, "act_batch", None, mesh={"data": 1}) is x
    with pytest.raises(ValueError, match="DTensor"):
        rules.constrain(x, "act_batch", None, mesh=SINGLE)


def test_fed_fanout_axis():
    assert rules.fed_fanout_axis(MULTI) == "pod"
    assert rules.fed_fanout_axis(SINGLE) is None
    assert jrules.fed_fanout_axis(FakeMesh(MULTI)) == "pod"
    assert rules.axis_size(MULTI, "pod") == 2
    assert rules.axis_size(SINGLE, "pod") == 1
