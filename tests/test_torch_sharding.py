"""The port's sharding rules (`repro_torch/parallel/sharding.py`) against
the JAX package's, on mesh geometry alone (no devices, no process group):
every parameter of every registered config on the 16 x 16 and
2 x 16 x 16 production meshes under both `shard_strategy` values, the
cache specs, and the reference's other `tests/test_sharding.py` cases
(its `test_hlo_*` cases parse XLA HLO, which a torch program has none
of). The port's parameters and caches are built on fake tensors.

The reference stacks a pattern slot's layers on a leading group axis
that the port's per-layer tensors do not have, so a port spec is the
reference's less that axis. Where the reference's `_fix_divisibility`
put an axis on the group axis (no other dim of the leaf divides it), the
port's layer is replicated over it: `GROUP_AXIS` names every such leaf.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import reference_leaf  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESH = sharding.Geometry({"data": 16, "model": 16})
MESH3 = sharding.Geometry({"pod": 2, "data": 16, "model": 16})
GEOMETRIES = {"16x16": MESH, "2x16x16": MESH3}

# (arch, mesh, strategy) -> {reference leaf: the axis its spec puts on the
# group axis}: none of the registered configs has one on either
# production mesh under either strategy (every axis that does not divide
# its own dim finds another dim of the layer); `test_group_axis_leaves`
# shows the case on a config cut to 16 layers of 16 groups
GROUP_AXIS: dict = {}


def _ref_name(path) -> str:
    return ".".join(k.strip("[]") for k in jsh._path_keys(path))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jconfigs.get_config(arch)
    params = jax.eval_shape(lambda k: jlm.lm_init(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(params)[0]


def _ref_leaves(arch, strategy="tp"):
    """The reference's config under `strategy` and its parameter leaves
    (the shapes do not depend on the strategy)."""
    import dataclasses
    cfg = dataclasses.replace(jconfigs.get_config(arch),
                              shard_strategy=strategy)
    return cfg, _ref_shapes(arch)


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = configs.get_config(arch)
    with FakeTensorMode():
        p = lm.lm_init(cfg, torch.Generator(), device="cpu")
        return {k: tuple(t.shape) for k, t in p.named_parameters()}


class _Leaf:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


@pytest.mark.parametrize("strategy", ["tp", "ep_dp"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_are_the_references(arch, geo, strategy):
    """Every port parameter's spec equals the reference's for its leaf,
    less the group axis of a stacked leaf; the leaves whose reference
    spec uses that axis are exactly GROUP_AXIS's."""
    import dataclasses
    mesh = GEOMETRIES[geo]
    jcfg, flat = _ref_leaves(arch, strategy)
    cfg = dataclasses.replace(configs.get_config(arch),
                              shard_strategy=strategy)
    ref = {_ref_name(p): (l.shape, tuple(jsh.param_spec(p, l, jcfg, mesh)))
           for p, l in flat}
    on_group = {}
    for name, shape in _port_shapes(arch).items():
        leaf = reference_leaf(name)
        ref_shape, ref_spec = ref[leaf]
        ref_spec = ref_spec + (None,) * (len(ref_shape) - len(ref_spec))
        got = sharding.param_spec(name, _Leaf(shape), cfg, mesh)
        if leaf != name:                        # a stacked layer
            assert ref_shape[1:] == shape, name
            if ref_spec[0] is not None:
                on_group[leaf] = ref_spec[0]
            ref_spec = ref_spec[1:]
        assert ref_shape[-len(shape):] == shape if shape else True
        assert got == ref_spec, (name, got, ref_spec)
    assert on_group == GROUP_AXIS.get((arch, geo, strategy), {})


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_divisible(arch):
    """Every parameter's sharding divides its dims on the production
    mesh (the precondition of an even DTensor layout)."""
    cfg = configs.get_config(arch)
    for name, shape in _port_shapes(arch).items():
        spec = sharding.param_spec(name, _Leaf(shape), cfg, MESH)
        for dim, ax in zip(shape, spec):
            if ax is not None:
                assert dim % sharding._axis_size(MESH, ax) == 0, (name, spec)


@functools.lru_cache(maxsize=None)
def _port_caches(arch):
    cfg = configs.get_config(arch)
    with FakeTensorMode():
        caches = lm.init_caches(cfg, 128, 1024, device="cpu")
    out = {}
    sharding.map_tree(lambda p, t: out.setdefault(p, tuple(t.shape)),
                       caches)
    return out


@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_cache_specs_divisible(arch):
    """Each cache tensor's spec divides its dims on 2 x 16 x 16 and is the
    reference's for the same field, less the group axis."""
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, 128, 1024))
    ref = {}
    for p, l in jax.tree_util.tree_flatten_with_path(jc)[0]:
        keys = jsh._path_keys(p)
        ref.setdefault((keys[0], keys[-1]), set()).add(
            tuple(jsh.cache_spec(p, l, jcfg, MESH3))[
                1 if "groups" in keys else 0:])
    for path, shape in _port_caches(arch).items():
        spec = sharding.cache_spec(path, _Leaf(shape), cfg, MESH3)
        for dim, ax in zip(shape, spec):
            if ax is not None:
                assert dim % sharding._axis_size(MESH3, ax) == 0, path
        keys = path.strip(".").split(".")
        assert ref[(keys[0], keys[-1])] == {spec}, (path, spec)


def test_moe_experts_sharded_on_model():
    cfg = configs.get_config("dbrx-132b")
    found = 0
    for name, shape in _port_shapes("dbrx-132b").items():
        keys = name.split(".")
        if ("mlp" in keys and keys[-1] in ("w_gate", "w_up", "w_down")
                and len(shape) >= 3 and 16 in shape):
            spec = sharding.param_spec(name, _Leaf(shape), cfg, MESH)
            assert spec[0] == "model", (name, spec)
            found += 1
    assert found >= 3


def test_batch_spec_small_batch_replicated():
    assert sharding.batch_spec(MESH3, 1, (1,)) == (None,)
    sp = sharding.batch_spec(MESH3, 2, (128, 5))
    assert sp[0] == ("pod", "data")
    assert sp == tuple(jsh.batch_spec(MESH3, 2, (128, 5)))
    ep = configs.get_config("deepseek-v2-lite-16b")
    import dataclasses
    ep = dataclasses.replace(ep, shard_strategy="ep_dp")
    assert sharding.batch_spec(MESH3, 2, (512, 5), ep)[0] == \
        ("pod", "data", "model")
    # too small for all three axes: the DP axes, then none
    assert sharding.batch_spec(MESH3, 2, (32, 5), ep) == \
        (("pod", "data"), None)
    assert sharding.batch_spec(MESH3, 2, (16, 5), ep) == (None, None)
    jep = dataclasses.replace(jconfigs.get_config("deepseek-v2-lite-16b"),
                              shard_strategy="ep_dp")
    for b in (512, 32, 16, 1):
        assert sharding.batch_spec(MESH3, 2, (b, 5), ep) == \
            tuple(jsh.batch_spec(MESH3, 2, (b, 5), jep)), b


def test_vocab_padding():
    cfg = configs.get_config("minicpm3-4b")
    assert cfg.vocab_padded % 16 == 0
    assert cfg.vocab_padded >= cfg.vocab
    cfg2 = configs.get_config("yi-34b")
    assert cfg2.vocab_padded == cfg2.vocab


def test_activation_policy_constrain_noop_without_policy():
    x = torch.ones((4, 8))
    assert sharding.constrain(x, ("batch", None)) is x
    # a plain tensor under a policy is left as it is too
    with sharding.activation_policy(MESH):
        assert sharding.constrain(x, ("batch", None)) is x
        assert sharding.resolve_spec((32, 8), ("batch", "model")) == \
            (("data",), None)                   # 8 does not divide by 16
        assert sharding.resolve_spec((32, 32), ("batch", "model")) == \
            (("data",), "model")


class _Mesh:
    """A DeviceMesh's names and shape, without devices."""
    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape
        self.ndim = len(shape)


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(("pod", "data", "model"), (2, 16, 16))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    # an axis of size 1 replicates
    assert sharding.placements(("data", "model"),
                               _Mesh(("data", "model"), (4, 1))) == \
        (Shard(0), Replicate())


def test_group_axis_leaves():
    """Mamba-2 cut to 16 layers of width 64: 16 groups on a 16-wide
    "model" axis that the layers' 8 heads do not divide. The reference
    puts "model" on the group axis of these leaves; the port's layers
    have no such dim and stay replicated over "model"."""
    jcfg = jconfigs.get_smoke_config("mamba2-780m", n_layers=16)
    cfg = configs.get_smoke_config("mamba2-780m", n_layers=16)
    params = jax.eval_shape(lambda k: jlm.lm_init(k, jcfg),
                            jax.random.PRNGKey(0))
    on_group = {}
    for p, l in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(jsh.param_spec(p, l, jcfg, MESH))
        if "groups" in jsh._path_keys(p) and spec[0] is not None:
            on_group[_ref_name(p)] = spec[0]
            port = sharding.param_spec(
                _ref_name(p).replace("groups.0.", "groups.0.3."),
                _Leaf(tuple(l.shape[1:])), cfg, MESH)
            assert port == spec[1:] and spec[0] not in port, (p, port)
    assert on_group == {f"stack.groups.0.attn.{k}": "model"
                        for k in ("A_log", "D", "dt_bias", "w_in")}
