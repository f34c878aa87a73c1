"""The port's launch and sharding layer against the JAX reference: the
logical axes of every parameter, ``ShardingRules`` on both production
meshes, ``input_specs``, the fabric's tenant sub-meshes and the sharding
hint.

The port's meshes live on a process group of PyTorch's "fake" backend
(``launch.mesh.fake_world``), opened inside each test and destroyed on
its exit, so no group leaks to another test file; the reference's on
``jax.sharding.AbstractMesh`` of the same shape.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models.layers import is_param  # noqa: E402
from repro.models.model import init_params as jax_init  # noqa: E402
from repro.models.shardings import ShardingRules as JaxRules  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.fabric import PARTITION_VOCABULARY  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.models.shardings import ShardingRules, placements  # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
#: the archs and shapes of test_gateway_specs.py::TestInputSpecs
SPEC_ARCHS = ("olmo-1b", "internvl2-76b", "seamless-m4t-medium",
              "deepseek-v2-lite-16b", "hymba-1.5b")


def _jax_leaves(tree, path=""):
    """(path, axes, shape) of every Param of a reference tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k],
                                                             f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _jax_leaves(v, f"{path}/{i}")]
    return [(path, tuple(tree.axes), tuple(tree.value.shape))]


def _torch_leaves(params, axes, path=""):
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _torch_leaves(params[k], axes[k], f"{path}/{k}")]
    if isinstance(params, list):
        return [x for i, (p, a) in enumerate(zip(params, axes))
                for x in _torch_leaves(p, a, f"{path}/{i}")]
    return [(path, tuple(axes), tuple(params.shape))]


def _reference_params(arch):
    return jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                           jax_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_matches_reference(arch):
    """Leaf by leaf, the port's logical axes (recorded by the init code on
    meta tensors) are the reference's ``Param.axes``, shapes too."""
    want = _jax_leaves(_reference_params(arch))
    params, axes = abstract_params(get_config(arch))
    got = _torch_leaves(params, axes)
    assert got == want
    assert all(t.device.type == "meta" for t in
               jax.tree.leaves(params))


def test_meta_init_draws_nothing():
    """Abstract parameters read no generator: a CPU generator's stream is
    where it was, and real parameters drawn after are those of a fresh
    draw."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.model import init_params
    cfg = smoke_config(get_config("olmo-1b"))
    gen = torch.Generator().manual_seed(7)
    before = gen.get_state()
    init_params(cfg, gen, device="meta")
    assert torch.equal(gen.get_state(), before)
    a = init_params(cfg, torch.Generator().manual_seed(7))
    b = init_params(cfg, gen)
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_param_specs_match_reference(multi_pod):
    """On (16, 16) and (2, 16, 16), every parameter of every arch gets the
    reference's PartitionSpec (fallbacks for dims that do not divide,
    row-parallel attention, FSDP embed included), and the placements put
    a tensor dim named by ("pod", "data") under both mesh dims."""
    shape, names = MESHES[multi_pod]
    abstract_mesh = AbstractMesh(shape, names)
    with mesh_lib.fake_world(int(torch.tensor(shape).prod())):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        assert mesh_lib.mesh_shape(mesh) == dict(zip(names, shape))
        assert mesh_lib.data_axis_names(mesh) == names[:-1]
        assert mesh_lib.mesh_chip_count(mesh) == mesh.size()
        for arch in ARCH_IDS:
            ref = JaxRules(jax_config(arch), abstract_mesh)
            rules = ShardingRules(get_config(arch), mesh)
            assert rules.param_rules == ref.param_rules
            assert rules.act_rules == ref.act_rules
            assert rules.attn_row_parallel == ref.attn_row_parallel
            params, axes = abstract_params(get_config(arch))
            got = dict((p, rules.param_spec(a, s))
                       for p, a, s in _torch_leaves(params, axes))
            want = dict((p, tuple(ref.param_spec(a, s)))
                        for p, a, s in _jax_leaves(_reference_params(arch)))
            assert got == want, arch
            for logical in (("batch", "seq", "embed"),
                            ("batch", "seq", "vocab"),
                            ("batch", "kv_seq", "kv_heads", "head_dim")):
                dims = (256, 32768, 256)[:len(logical)] + (64,) * (
                    len(logical) - 3)
                assert rules.act_spec(logical, dims) == tuple(
                    ref.act_spec(logical, dims))
        if multi_pod:
            from torch.distributed.tensor import Replicate, Shard
            assert placements((("pod", "data"), None, "model"), mesh) == (
                Shard(0), Shard(0), Shard(2))
            assert placements((None, None), mesh) == (Replicate(),) * 3


def _spec_tree(tree):
    """(path, shape, dtype name, spec) of every leaf of the reference's
    specs, the spec normalised (1-tuples to their name)."""
    out = []

    def norm(ax):
        return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        spec = tuple(norm(a) for a in leaf.sharding.spec)
        spec += (None,) * (len(leaf.shape) - len(spec))
        out.append((key, tuple(leaf.shape), jax.numpy.dtype(
            leaf.dtype).name, spec))
    return sorted(out)


def _port_spec_tree(tree, path=""):
    if isinstance(tree, dict):
        return sorted(x for k, v in tree.items()
                      for x in _port_spec_tree(v, f"{path}{k}/"))
    if isinstance(tree, list):
        return sorted(x for i, v in enumerate(tree)
                      for x in _port_spec_tree(v, f"{path}{i}/"))
    name = str(tree.dtype).replace("torch.", "")
    return [(path[:-1], tuple(tree.shape), name, specs.spec_of(tree))]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_input_specs_match_reference(multi_pod):
    """``input_specs`` for the archs of ``TestInputSpecs`` at every shape:
    the reference's shapes, dtypes and specs leaf by leaf (decode caches
    from the port's ``init_cache`` on meta), every leaf a meta DTensor."""
    shape, names = MESHES[multi_pod]
    abstract_mesh = AbstractMesh(shape, names)
    with mesh_lib.fake_world(int(torch.tensor(shape).prod())):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        for arch in SPEC_ARCHS:
            for shape_name, sh in SHAPES.items():
                want = _spec_tree(jax_specs.input_specs(
                    jax_config(arch), sh, abstract_mesh))
                got_tree = specs.input_specs(get_config(arch), sh, mesh)
                assert _port_spec_tree(got_tree) == want, (arch, shape_name)
                for leaf in jax.tree.leaves(got_tree):
                    assert leaf.to_local().device.type == "meta"


def test_tenant_submesh_vocabulary():
    """Only the fabric's 1/2/4/8 shapes carve a tenant; each is a
    (1, size) ("data", "model") mesh over the grid's first ranks."""
    with mesh_lib.fake_world(16):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        for size in PARTITION_VOCABULARY:
            sub = mesh_lib.tenant_submesh(mesh, size)
            assert tuple(sub.shape) == (1, size)
            assert sub.mesh_dim_names == ("data", "model")
            assert sub.mesh.reshape(-1).tolist() == list(range(size))
        for size in (0, 3, 5, 6, 7, 16):
            with pytest.raises(ValueError, match="not in"):
                mesh_lib.tenant_submesh(mesh, size)


def test_shard_hint_without_resolver_is_identity():
    """No resolver installed (the serving and training paths): the hint
    returns its very input, and the FSDP gather returns the tree."""
    layers.set_activation_resolver(None)
    x = torch.randn(2, 3, 4)
    assert layers.shard_hint(x, ("batch", "seq", "embed")) is x
    tree = {"w": x}
    assert layers.gather_for_use(tree) is tree


def test_no_group_at_import():
    """Importing the launch and sharding modules opens no process group."""
    import torch.distributed as dist
    import repro_torch.launch.cost_analysis  # noqa: F401
    import repro_torch.launch.dryrun  # noqa: F401
    import repro_torch.launch.elastic  # noqa: F401
    assert not dist.is_initialized()
