"""The port's dry-run cells, abstract inputs and roofline arithmetic against
the JAX package's, in one process (host values only, compared with ``==``
unless a tolerance is stated).

* the 33 ``(arch, shape)`` cells, the shapes and the long-context archs;
* for every cell, ``input_specs``: the same step kind and, leaf for leaf,
  the same path, shape and dtype as the reference's ``ShapeDtypeStruct``
  (and the same ``_max_len`` ints), each leaf a ``meta`` tensor;
* ``active_param_count`` of all ten archs' published configs;
* ``roofline_terms`` (``rel 1e-12``) and ``model_flops`` (exact) on the
  H100 constants, and the reference's arithmetic on its own constants.
"""

import pytest
import torch

from repro_torch.configs import SHAPES, all_cells, get_config, shapes_for
from repro_torch.launch import roofline as tr
from repro_torch.launch.specs import ENCDEC_DECODE_SRC_LEN, ENCDEC_PREFILL_SELF_CACHE, input_specs
from repro_torch.models.param import named_leaves
from repro_torch.models.registry import build_model

jax = pytest.importorskip("jax")
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import all_cells as jax_all_cells  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro.launch import roofline as jr  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402

ARCHS = sorted({a for a, _ in jax_all_cells()})


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): v
            for path, v in flat}


def test_cells_and_shapes_equal_the_reference():
    assert all_cells() == jax_all_cells()
    assert len(all_cells()) == 33
    for arch in ARCHS:
        assert shapes_for(arch) == jax_shapes_for(arch)
    assert set(SHAPES) == set(JAX_SHAPES)
    for name, s in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert (ENCDEC_DECODE_SRC_LEN, ENCDEC_PREFILL_SELF_CACHE) == (
        jspecs.ENCDEC_DECODE_SRC_LEN, jspecs.ENCDEC_PREFILL_SELF_CACHE)


@pytest.mark.parametrize("cell", all_cells(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_equal_the_reference(cell):
    arch, shape = cell
    kind, got = input_specs(get_config(arch), SHAPES[shape])
    jkind, want = jspecs.input_specs(jax_config(arch), JAX_SHAPES[shape])
    assert kind == jkind
    got = dict(named_leaves(got))
    want = _jax_leaves(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, int):
            assert g == w, path
            continue
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_equals_the_reference(arch):
    got = tr.active_param_count(get_config(arch), build_model(get_config(arch)).param_specs())
    want = jr.active_param_count(jax_config(arch),
                                 jax_build_model(jax_config(arch)).param_specs())
    assert got == want


def test_roofline_terms_and_model_flops_math():
    assert (tr.PEAK_FLOPS, tr.HBM_BW, tr.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = tr.roofline_terms(flops_per_dev=989e12, bytes_per_dev=3.35e12, coll_bytes_per_dev=0.0)
    assert t["t_compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert t["t_memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert t["t_collective_s"] == 0.0
    assert t["dominant"] in ("compute", "memory")
    assert t["roofline_fraction"] == pytest.approx(1.0, rel=1e-12)
    t2 = tr.roofline_terms(flops_per_dev=1e12, bytes_per_dev=1e9, coll_bytes_per_dev=450e9)
    assert t2["dominant"] == "collective"
    assert t2["t_collective_s"] == pytest.approx(1.0, rel=1e-12)
    assert t2["roofline_fraction"] == pytest.approx(1e12 / 989e12, rel=1e-12)
    assert tr.roofline_terms(flops_per_dev=0, bytes_per_dev=0,
                             coll_bytes_per_dev=0)["roofline_fraction"] == 0.0
    assert tr.model_flops(1e9, 0, 1000, "train") == 6e12
    assert tr.model_flops(1e9, 5e8, 1000, "prefill") == 2 * 5e8 * 1000
    for args in ((7e9, 0, 4096, "train"), (7e9, 1e9, 128, "decode")):
        assert tr.model_flops(*args) == jr.model_flops(*args)


def test_specs_allocate_nothing():
    _, inputs = input_specs(get_config("llama3_405b"), SHAPES["train_4k"])
    leaves = [leaf for _, leaf in named_leaves(inputs) if torch.is_tensor(leaf)]
    assert leaves and all(leaf.device.type == "meta" for leaf in leaves)
