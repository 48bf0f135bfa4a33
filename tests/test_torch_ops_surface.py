"""The port's ops surface against the JAX package's: ``spec_json`` key for
key on every spec type, the ``block_q`` tiles accepted and refused as the
reference does, and the registry's ``unregister`` / ``registered_ops`` /
``active_overrides`` (exact equality throughout: these are host values)."""

import json

import pytest

from repro_torch import ops as tops
from repro_torch.core.fixedpoint import FixedPointFormat as TFormat
from repro_torch.hwmodel.faults import FaultModel as TFault
from repro_torch.ops import registry as treg

jops = pytest.importorskip("repro.ops")
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.hwmodel.faults import FaultModel as JFault  # noqa: E402
from repro.ops import registry as jreg  # noqa: E402


def _pair(name, **kw):
    """The same spec built in both packages."""
    return getattr(tops, name)(**kw), getattr(jops, name)(**kw)


CASES = [
    ("SoftmaxSpec", {}),
    ("SoftmaxSpec", {"impl": "pallas", "mode": "histogram", "block_rows": 16}),
    ("SoftmaxSpec", {"kind": "exact", "precision": "auto:mrpc"}),
    ("AttentionSpec", {}),
    ("AttentionSpec", {"impl": "pallas", "causal": True, "sliding_window": 64,
                       "ragged": True, "block_q": 64, "block_k": 32, "pv_int8": True}),
    ("PagedAttentionSpec", {}),
    ("PagedAttentionSpec", {"impl": "pallas_paged", "block_size": 32, "block_q": 8,
                            "kv_dtype": "int8"}),
    ("MatmulSpec", {}),
    ("MatmulSpec", {"impl": "hwmodel", "ranging": "fullscale", "block_m": 64}),
    ("ScanSpec", {}),
    ("ScanSpec", {"chunk": 64}),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_spec_json_equals_the_reference(name, kw):
    t, j = _pair(name, **kw)
    got, want = tops.spec_json(t), jops.spec_json(j)
    assert got == want
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_spec_json_with_a_fault_and_a_format():
    fmt = dict(int_bits=5, frac_bits=3)
    fault = dict(seed=3, g_sigma=0.1, stuck_on_rate=0.01)
    t = tops.AttentionSpec(softmax=tops.SoftmaxSpec(precision=TFormat(**fmt)),
                           fault=TFault(**fault))
    j = jops.AttentionSpec(softmax=jops.SoftmaxSpec(precision=JFormat(**fmt)),
                           fault=JFault(**fault))
    assert tops.spec_json(t) == jops.spec_json(j)
    t, j = tops.MatmulSpec(fault=TFault(**fault)), jops.MatmulSpec(fault=JFault(**fault))
    assert tops.spec_json(t) == jops.spec_json(j)


@pytest.mark.parametrize("name", ["AttentionSpec", "PagedAttentionSpec"])
@pytest.mark.parametrize("block_q", [1, 64, 128, 0, -8])
def test_block_q_accepted_and_refused_as_the_reference(name, block_q):
    try:
        want = getattr(jops, name)(block_q=block_q)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            getattr(tops, name)(block_q=block_q)
        assert str(got.value) == str(e)
        return
    got = getattr(tops, name)(block_q=block_q)
    assert got.block_q == want.block_q == block_q


def test_registered_ops_and_unregister_match_the_reference():
    assert tops.registered_ops() == jops.registered_ops()

    def stub(spec, x, **kw):
        return x

    for reg in (treg, jreg):
        reg.register("test_only_op", "stub", stub)
        assert "test_only_op" in reg.registered_ops()
        reg.unregister("test_only_op", "stub")
        assert "test_only_op" not in reg.registered_ops()
        reg.unregister("test_only_op", "stub")  # a missing key is no error
    with pytest.raises(tops.UnknownBackendError, match="no backends registered"):
        treg.get("test_only_op", "stub")
    with pytest.raises(jops.UnknownBackendError, match="no backends registered"):
        jreg.get("test_only_op", "stub")


def test_active_overrides_match_the_reference():
    assert treg.active_overrides("softmax") == jreg.active_overrides("softmax") == {}
    with tops.use(softmax="reference", attention="xla"), jops.use(softmax="reference",
                                                                  attention="xla"):
        with tops.use(attention="pallas"), jops.use(attention="pallas"):
            for op in ("softmax", "attention", "paged_attention"):
                assert treg.active_overrides(op) == jreg.active_overrides(op), op
                assert treg.active_impl(op) == jreg.active_overrides(op).get("impl")
        assert treg.active_overrides("attention") == {"impl": "xla"}
    assert treg.active_overrides("attention") == {}
