"""The port's logical sharding rules against the JAX package's, in one
process with no process group: both resolve logical axes through the mesh's
``shape`` alone, so one stub object with a ``shape`` dict serves both.
Everything here is host values, compared with ``==``.

* ``logical_to_pspec`` on a grid of axes, shapes, rules (the defaults and
  overrides) and meshes ``(2, 2)``, ``(4, 2)`` and ``(2, 16, 16)`` with
  "pod"; ``param_pspecs`` and ``bytes_per_device`` of every arch's smoke
  and full config;
* ``axes_tree`` of every arch's smoke config;
* ``placements``: the DTensor placements of a spec on a mesh.
"""

import itertools

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as ts
from repro_torch.models.param import ParamSpec, axes_tree, named_leaves, stack_specs
from repro_torch.models.registry import build_model

jax = pytest.importorskip("jax")
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import sharding as js  # noqa: E402
from repro.models.param import axes_tree as jax_axes_tree  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402


class StubMesh:
    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {
    "2x2": StubMesh(data=2, model=2),
    "4x2": StubMesh(data=4, model=2),
    "pod": StubMesh(pod=2, data=16, model=16),
}
RULES = {
    "default": ts.DEFAULT_RULES,
    "overrides": ts.make_rules(embed=None, mlp=("model", "data"), batch="data",
                               kv_heads=("data", "model"), vocab=None),
}
JAX_RULES = {
    "default": js.DEFAULT_RULES,
    "overrides": js.make_rules(embed=None, mlp=("model", "data"), batch="data",
                               kv_heads=("data", "model"), vocab=None),
}
LOGICAL = ["batch", "embed", "mlp", "heads", "kv_heads", "vocab", "expert", "act_seq",
           "kv_seq", "layers", None, "unknown"]
DIMS = [1, 2, 6, 8, 16, 32, 48, 64, 512]


def _tuple(pspec):
    return tuple(pspec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
def test_make_rules_and_logical_to_pspec_match_the_reference(mesh, rules):
    assert RULES[rules] == JAX_RULES[rules]
    m = MESHES[mesh]
    n = 0
    for a, b in itertools.product(LOGICAL, repeat=2):
        for d0, d1 in itertools.product(DIMS, repeat=2):
            for axes, shape in (((a, b), (d0, d1)), ((a, b, "embed"), (d0, d1, 64))):
                want = _tuple(js.logical_to_pspec(axes, shape, JAX_RULES[rules], m))
                assert ts.logical_to_pspec(axes, shape, RULES[rules], m) == want, (axes, shape)
                n += 1
    assert n == 2 * len(LOGICAL) ** 2 * len(DIMS) ** 2


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("full", [False, True])
def test_param_pspecs_and_bytes_per_device_match_the_reference(arch, full):
    cfg = (get_config if full else get_smoke_config)(arch)
    jcfg = (jax_config if full else jax_smoke_config)(arch)
    specs = build_model(cfg).param_specs()
    jspecs = jax_build_model(jcfg).param_specs()
    for name, mesh in MESHES.items():
        for rules in RULES:
            got = dict(named_leaves(ts.param_pspecs(specs, RULES[rules], mesh)))
            want = js.param_pspecs(jspecs, JAX_RULES[rules], mesh)
            want = dict(named_leaves(jax.tree.map(_tuple, want,
                                                  is_leaf=lambda x: hasattr(x, "_partitions"))))
            assert got == want, (name, rules)
            assert ts.bytes_per_device(specs, RULES[rules], mesh) == \
                js.bytes_per_device(jspecs, JAX_RULES[rules], mesh), (name, rules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_matches_the_reference(arch):
    got = axes_tree(build_model(get_smoke_config(arch)).param_specs())
    want = jax_axes_tree(jax_build_model(jax_smoke_config(arch)).param_specs())
    assert got == want


def test_param_spec_checks_its_axes():
    with pytest.raises(ValueError, match="do not match shape"):
        ParamSpec((2, 3), ("embed",))
    stacked = stack_specs({"w": ParamSpec((2, 3), ("embed", "mlp"))}, 4)
    assert stacked["w"].shape == (4, 2, 3) and stacked["w"].axes == ("layers", "embed", "mlp")


class StubDeviceMesh:
    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StubDeviceMesh(pod=2, data=2, model=2)
    assert ts.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0),
                                                                    Shard(2))
    assert ts.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert ts.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        ts.placements((("data", "pod"),), mesh)
    assert ts.mesh_shape(mesh) == {"pod": 2, "data": 2, "model": 2}


def test_constraint_is_the_identity_outside_a_mesh():
    x = torch.ones(2, 3)
    assert ts.current_mesh_rules() is None
    assert ts.with_logical_constraint(x, ("batch", "embed")) is x
    with ts.use_mesh_rules(None):
        assert ts.current_mesh_rules() is None
        assert ts.with_logical_constraint(x, ("batch", "embed")) is x


def test_engines_refuse_a_mesh():
    """Serving over a mesh is not ported: both engines raise the named
    error under ``use_mesh_rules``, and serve outside it."""
    from repro_torch.models.param import materialize
    from repro_torch.serve.engine import (
        ContinuousBatchingEngine, MeshNotServedError, ServeEngine)

    cfg = get_smoke_config("granite_8b")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    for engine in (ServeEngine, ContinuousBatchingEngine):
        with ts.use_mesh_rules(StubDeviceMesh(data=1, model=1)):
            with pytest.raises(MeshNotServedError, match="not ported"):
                engine(cfg, params, device="cpu")
        engine(cfg, params, device="cpu")
    assert issubclass(MeshNotServedError, NotImplementedError)


def test_production_mesh_and_make_mesh_need_a_process_group():
    """The reference's ``make_production_mesh`` error on a world too small
    (``tests/test_launch_specs.py``); ``make_mesh`` needs a process group
    and a shape that matches its axes."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    assert not torch.distributed.is_initialized()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",), "cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh((1, 1), ("data", "model"), "cpu")
