"""The MoE family (granite-moe-1b-a400m and mixtral-8x22b smoke configs)
against the JAX reference with the same weights and inputs.

Weights and inputs come from seeds through numpy (``from_reference``).  The
JAX side keeps its default routes (attention ``xla``, softmax
``reference``); the port runs ``attn_impl="pallas"`` under
``ops.use(softmax="pallas")``, so the router and attention go through the
kernel wrappers, which run their plain versions on the CPU.  Tolerances:
MoE outputs within 1e-5 of the largest output (float32 sums in another
order; the router's STAR snap is exact); logits at ``atol=1e-4``; expert
counts, expert choices and greedy tokens identical.

The block dispatches by index; ``moe_one_hot`` keeps the one-hot einsum
form it replaced as its oracle, without JAX: the experts' queues and the
counts bit-equal, outputs within MOE_RTOL, gradients within float32
rounding, and no intermediate that grows as the prompt's square.

The ``cuda`` tests hold the STAR softmax kernel bit-equal to its plain
version at the router's shapes, the index route to the one-hot form at
granite-moe's width in bfloat16, and the granite-moe smoke tick's replay
bit-equal to its eager tick; they skip where there is no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.star_softmax import kernel as sk
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as L
from repro_torch.models.param import count_params, from_reference, materialize, tree_map
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graph as graph_mod
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    ContinuousConfig,
    ServeConfig,
    ServeEngine,
)

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro import ops as jops
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import layers as JL
    from repro.models.param import count_params as jax_count_params
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
    from repro.serve.engine import ContinuousConfig as JaxConfig
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:
    jax = None

ARCHS = ("granite_moe_1b_a400m", "mixtral_8x22b")
MOE_RTOL = 1e-5  # of the largest |output|: float32 sums in another order
ATOL = 1e-4  # logits
MAX_LEN = 40
RING_LENS = (20, 11, 18, 3)  # mixtral's window is 16: the longer prompts wrap it


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the JAX config and weights, the port's config and the same
    weights."""
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    out = {}
    for arch in ARCHS:
        cfg_j = jax_smoke_config(arch)
        params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
        cfg_t = dataclasses.replace(get_smoke_config(arch), attn_impl="pallas")
        params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _moe_params(pairs, arch):
    """Layer 0's MoE weights of both packages."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    pj = jax.tree_util.tree_map(lambda a: a[0], params_j["blocks"]["moe"])
    pt = {k: v[0] for k, v in params_t["blocks"]["moe"].items()}
    return cfg_j, pj, cfg_t, pt


def _x(seed, b, t, d):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _moe_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MOE_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_parameter_counts_follow_the_reference(arch, pairs):
    """The published widths (as ``tests/test_models_smoke.py`` checks them),
    the smoke config field for field, and the parameter count of both."""
    full = get_config(arch)
    got = (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
           full.vocab_size, full.num_experts, full.top_k)
    want = {"granite_moe_1b_a400m": (24, 1024, 16, 8, 512, 49155, 32, 8),
            "mixtral_8x22b": (56, 6144, 48, 8, 16384, 32768, 8, 2)}[arch]
    assert got == want
    assert full.sliding_window == (4096 if arch == "mixtral_8x22b" else None)
    for mine, ref in ((full, jax_config(arch)), (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    n = count_params(build_model(full).param_specs())
    assert n == jax_count_params(jax_build_model(jax_config(arch)).param_specs())
    lo, hi = {"granite_moe_1b_a400m": (1.2e9, 1.5e9), "mixtral_8x22b": (130e9, 150e9)}[arch]
    assert lo < n < hi


def test_a_moe_config_needs_experts_and_top_k():
    cfg = get_smoke_config("granite_moe_1b_a400m")
    for bad in (dict(num_experts=0), dict(top_k=0)):
        with pytest.raises(ValueError, match="num_experts > 0 and top_k > 0"):
            dataclasses.replace(cfg, **bad).validate()
    hybrid = dataclasses.replace(cfg, family="hybrid")  # no block_pattern
    with pytest.raises(ValueError, match="needs a block_pattern"):
        build_model(hybrid)
    with pytest.raises(ValueError, match="dense and moe families"):
        DecoderLM(hybrid)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rnn"))


# ---------------------------------------------------------------------------
# the MoE layer


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax_bare_and_stateful(arch, pairs):
    """The bare call, and the stateful call with prior counts and a
    capacity: outputs within MOE_RTOL, the counts bit-equal."""
    cfg_j, pj, cfg_t, pt = _moe_params(pairs, arch)
    x = _x(1, 3, 24, cfg_t.d_model)
    with ops.use(softmax="pallas"):
        got = L.moe(pt, torch.as_tensor(x), cfg_t)
    _moe_close(got, JL.moe(pj, jnp.asarray(x), cfg_j))
    prior = np.random.default_rng(2).integers(0, 4, (3, cfg_t.num_experts)).astype(np.int32)
    y_j, s_j = JL.moe(pj, jnp.asarray(x), cfg_j, state=jnp.asarray(prior), capacity=9)
    with ops.use(softmax="pallas"):
        y_t, s_t = L.moe(pt, torch.as_tensor(x), cfg_t, state=torch.as_tensor(prior),
                         capacity=9)
    _moe_close(y_t, y_j)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # counts include dropped choices: every token's k choices are counted
    assert (s_t - torch.as_tensor(prior)).sum(-1).tolist() == [24 * cfg_t.top_k] * 3


def test_top_k_puts_the_lower_index_first_on_ties(pairs):
    row = [0.25, 0.5, 0.5, 0.25, 0.5, 0.1]
    vals, idx = L.top_k(torch.tensor([row]), 3)
    _, ji = jax.lax.top_k(jnp.asarray([row]), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[0.5, 0.5, 0.5]]
    # quantized STAR probabilities tie often: every order as lax.top_k's
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    probs = sk.star_softmax_ref(x, FMT)
    assert len(set(probs[0].tolist())) < 8  # ties in a row
    for k in (1, 2, 3, 5):
        _, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(L.top_k(probs, k)[1].numpy(), np.asarray(ji))


def test_a_tie_across_the_kth_place_picks_the_reference_experts(pairs):
    """Experts 3 and 5 get the same router column, so their probabilities
    tie exactly; tokens where the tie straddles the k-th place choose
    expert 3, as ``lax.top_k`` does, and the counts and outputs follow the
    reference's."""
    cfg_j, pj, cfg_t, pt = _moe_params(pairs, "granite_moe_1b_a400m")
    router = np.asarray(pj["router"]).copy()
    router[:, 5] = router[:, 3]
    pj = dict(pj, router=jnp.asarray(router))
    pt = dict(pt, router=torch.as_tensor(router))
    x = _x(3, 2, 32, cfg_t.d_model)
    with ops.use(softmax="pallas"):
        logits = (torch.as_tensor(x) @ pt["router"]).float()
        probs = ops.softmax(logits, L.router_spec(cfg_t))
        y_t, s_t = L.moe(pt, torch.as_tensor(x), cfg_t, capacity=64)
    k = cfg_t.top_k
    tied = probs[..., 3:4]
    # one place left above the pair, and no other expert in the tie
    straddle = (((probs > tied).sum(-1) == k - 1) & ((probs == tied).sum(-1) == 2))
    assert bool((probs[..., 3] == probs[..., 5]).all()) and int(straddle.sum()) > 0
    idx = L.top_k(probs, k)[1]
    assert bool((idx == 3).any(-1)[straddle].all()) and not bool((idx == 5).any(-1)[straddle].any())
    _, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    y_j, s_j = JL.moe(pj, jnp.asarray(x), cfg_j, capacity=64)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    _moe_close(y_t, y_j)


def test_a_small_capacity_drops_the_reference_choices(pairs):
    """capacity 2 over 24 tokens a group: most choices drop; the outputs
    (a dropped choice weighs nothing) and counts follow the reference's."""
    cfg_j, pj, cfg_t, pt = _moe_params(pairs, "mixtral_8x22b")
    x = _x(4, 2, 24, cfg_t.d_model)
    with ops.use(softmax="pallas"):
        y_t, s_t = L.moe(pt, torch.as_tensor(x), cfg_t, capacity=2)
        full = L.moe(pt, torch.as_tensor(x), cfg_t, capacity=64)[0]
    y_j, s_j = JL.moe(pj, jnp.asarray(x), cfg_j, capacity=2)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert int(s_t.max()) > 2  # choices past the queue's end were dropped
    _moe_close(y_t, y_j)
    assert not torch.allclose(y_t, full)  # and the drops change the output


@pytest.mark.parametrize("how", ["star_router_off", "exact_kind"])
def test_an_exact_router_takes_the_reference_route(how, pairs, monkeypatch):
    """``star_router=False`` or an exact softmax kind: the router's oracle
    runs on the ``reference`` impl (the kernel backend is STAR only), even
    where the config names ``pallas`` (mirrors
    ``tests/test_ops_registry.py::test_moe_router_exact_falls_back_from_star_only_impl``);
    the STAR router under ``ops.use(softmax="pallas")`` reaches the kernel
    wrapper."""
    cfg_j, pj, cfg_t, pt = _moe_params(pairs, "granite_moe_1b_a400m")
    change = (dict(star_router=False) if how == "star_router_off"
              else dict(softmax_kind="exact"))
    cfg_t = dataclasses.replace(cfg_t, softmax=ops.SoftmaxSpec(impl="pallas", kind="star"),
                                **change)
    cfg_j = dataclasses.replace(cfg_j, softmax=jops.SoftmaxSpec(impl="pallas", kind="star"),
                                **change)
    spec = L.router_spec(cfg_t)
    assert (spec.kind, spec.impl) == ("exact", "reference")
    calls = []
    real = sk.star_softmax_ref
    monkeypatch.setattr(sk, "star_softmax_ref", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = _x(5, 2, 8, cfg_t.d_model)
    got = L.moe(pt, torch.as_tensor(x), cfg_t)
    assert bool(torch.isfinite(got).all()) and not calls
    _moe_close(got, JL.moe(pj, jnp.asarray(x), cfg_j))
    star = dataclasses.replace(cfg_t, star_router=True, softmax_kind="star")
    with ops.use(softmax="pallas"):
        L.moe(pt, torch.as_tensor(x), star)
    assert calls == [1]


# ---------------------------------------------------------------------------
# dispatch by index against the one-hot form it replaced


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_one_hot(p, x, cfg, *, state=None, capacity=None, span=None):
    """The MoE block by one-hot dispatch and combine (the reference's
    einsums, float32 dispatch over ``[g, t, e, cap]``): the oracle of the
    index route.  Returns ``(y, counts, xin)``."""
    dt = L.cdtype(cfg)
    g, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = (x @ p["router"].to(dt)).float()
    probs = ops.softmax(logits, L.router_spec(cfg))
    gate_vals, gate_idx = L.top_k(probs, k)
    total = gate_vals[..., 0]
    for i in range(1, k):
        total = total + gate_vals[..., i]
    gate_vals = gate_vals / torch.clamp(total, min=1e-9)[..., None]
    cap = capacity if capacity is not None else L.moe_capacity(cfg, t)
    onehot = _one_hot(gate_idx, e)
    flat = onehot.reshape(g, t * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, t, k, e)
    if state is not None:
        pos = pos + state.float()[:, None, None, :]
    pos = (pos * onehot).sum(dim=-1)
    keep = pos < cap
    gate_vals = gate_vals * keep
    pos_oh = _one_hot(pos.long(), cap)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, gate_vals)
    if span is not None:
        dispatch = dispatch[:, :, span[0]:span[0] + span[1]]
        combine = combine[:, :, span[0]:span[0] + span[1]]
    xin = torch.einsum("gtec,gtd->egcd", dispatch, x.float()).to(dt)
    h = torch.einsum("egcd,edf->egcf", xin, p["wi"].to(dt))
    g_ = torch.einsum("egcd,edf->egcf", xin, p["wg"].to(dt))
    out = torch.einsum("egcf,efd->egcd", torch.nn.functional.silu(g_) * h, p["wo"].to(dt))
    y = torch.einsum("gtec,egcd->gtd", combine.to(dt), out)
    counts = onehot.sum(dim=(1, 2)).to(torch.int32)
    return y, counts if state is None else state + counts, xin


def _routed(p, x, cfg, monkeypatch, **kw):
    """``L._moe`` with the queues its experts read: ``(y, counts, xin)``
    (``counts`` None from the bare form)."""
    seen = []
    real = L._experts
    monkeypatch.setattr(L, "_experts", lambda p_, xin, dt: seen.append(xin) or real(p_, xin, dt))
    out = L._moe(p, x, cfg, **kw)
    monkeypatch.setattr(L, "_experts", real)
    y, counts = out if isinstance(out, tuple) else (out, None)
    (xin,) = seen
    return y, counts, xin


def _moe_case(case):
    """The smoke granite-moe block (8 experts, top-2) with an exact router
    (the STAR router passes no gradient to its logits) and the call's
    keywords for one oracle case."""
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), star_router=False)
    p = materialize(L.spec_moe(cfg), 21, "cpu")
    x = torch.as_tensor(_x(22, 3, 24, cfg.d_model))
    kw = {}
    if case == "stateful":  # prior counts, capacity 2: most choices drop
        kw = dict(state=torch.randint(0, 4, (3, cfg.num_experts), dtype=torch.int32,
                                      generator=torch.Generator().manual_seed(23)),
                  capacity=2)
    elif case.startswith("span"):  # one rank's half of the experts
        n = cfg.num_experts // 2
        e0 = 0 if case == "span_low" else n
        p = dict(p, **{w: p[w][e0:e0 + n] for w in ("wi", "wg", "wo")})
        kw = dict(span=(e0, n))
    elif case == "tie":  # experts 3 and 5 tie; at k = 2 the tie straddles the k-th place
        router = p["router"].clone()
        router[:, 5] = router[:, 3]
        p = dict(p, router=router)
        kw = dict(capacity=64)
    return cfg, p, x, kw


@pytest.mark.parametrize("case", ["bare", "stateful", "span_low", "span_high", "tie"])
def test_the_index_route_matches_the_one_hot_oracle(case, monkeypatch):
    """The experts' queues and the counts bit-equal to the one-hot form's,
    the output within MOE_RTOL, and the gradients with respect to ``x``,
    the router and the experts within float32 rounding of the oracle's."""
    cfg, p, x, kw = _moe_case(case)
    names = ("router", "wi", "wg", "wo")
    runs = []
    for route in ("index", "one_hot"):
        leaves = {w: p[w].clone().requires_grad_() for w in names}
        xr = x.clone().requires_grad_()
        if route == "index":
            y, counts, xin = _routed(leaves, xr, cfg, monkeypatch, **kw)
        else:
            y, counts, xin = moe_one_hot(leaves, xr, cfg, **kw)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(24))
        grads = torch.autograd.grad((y * cot).sum(), [xr] + [leaves[w] for w in names])
        runs.append((y.detach(), counts, xin.detach(), grads))
    (y, counts, xin, grads), (y_o, counts_o, xin_o, grads_o) = runs
    assert torch.equal(xin, xin_o)
    if "state" in kw or "capacity" in kw:
        assert counts.dtype == torch.int32 and torch.equal(counts, counts_o)
    if case == "stateful":
        assert int(counts.max()) > 2  # choices past the queue's end were dropped
    if case == "tie":
        probs = ops.softmax((x @ p["router"]).float(), L.router_spec(cfg))
        straddle = (((probs > probs[..., 3:4]).sum(-1) == cfg.top_k - 1)
                    & ((probs == probs[..., 3:4]).sum(-1) == 2))
        assert int(straddle.sum()) > 0
    _moe_close(y, y_o.numpy())
    for name, got, want in zip(("x",) + names, grads, grads_o):
        assert float(want.abs().max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=MOE_RTOL * float(want.abs().max()), err_msg=name)


def test_the_experts_halves_sum_to_the_whole_block(monkeypatch):
    """Under ``span`` each half of the experts returns its part of the
    output; the two parts sum to the bare block's output."""
    cfg, p, x, _ = _moe_case("bare")
    whole = L._moe(p, x, cfg)
    parts = [L._moe(q, x, cfg, **kw) for q, x, kw in
             (_moe_case(c)[1:] for c in ("span_low", "span_high"))]
    _moe_close(parts[0] + parts[1], whole.numpy())


class _Sizes(torch.utils._python_dispatch.TorchDispatchMode):
    """The element count of every op's outputs."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in torch.utils._pytree.tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                self.numels.append(leaf.numel())
        return out


def _largest_intermediate(block, t):
    cfg = get_smoke_config("granite_moe_1b_a400m")
    p = materialize(L.spec_moe(cfg), 25, "cpu")
    x = torch.as_tensor(_x(26, 1, t, cfg.d_model))
    with _Sizes() as sizes:
        block(p, x, cfg, capacity=L.moe_capacity(cfg, t))
    return max(sizes.numels)


def test_no_tensor_of_the_block_grows_with_the_square_of_the_prompt():
    """A prefill's capacity grows with the prompt, so a ``[t, e, cap]``
    tensor grows as t²: from 256 to 1024 tokens the one-hot form's largest
    intermediate grows 16x, the index route's as the tokens (4x)."""
    grow = _largest_intermediate(L.moe, 1024) / _largest_intermediate(L.moe, 256)
    assert grow <= 4.5
    assert _largest_intermediate(moe_one_hot, 1024) / _largest_intermediate(moe_one_hot, 256) > 15


def test_the_dispatch_counter_counts_choices_and_slots():
    """``moe.dispatch.rows``: ``routed`` the ``g·t·k`` choices, ``slots``
    the ``e·g·cap`` queue rows the experts compute, for a bare and a
    stateful call (whose capacity is the caller's)."""
    from repro_torch import obs

    cfg, p, x, _ = _moe_case("bare")
    g, t = x.shape[:2]
    e, k = cfg.num_experts, cfg.top_k
    for kw, cap in (({}, L.moe_capacity(cfg, t)),
                    (dict(state=torch.zeros(g, e, dtype=torch.int32), capacity=9), 9)):
        mine = obs.MetricsRegistry()
        prev = obs.set_default_registry(mine)
        try:
            L.moe(p, x, cfg, **kw)
        finally:
            obs.set_default_registry(prev)
        rows = mine.counter("moe.dispatch.rows")
        assert rows.value(kind="routed") == g * t * k
        assert rows.value(kind="slots") == e * g * cap


# ---------------------------------------------------------------------------
# the model: prefill, chunks, decode


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, pairs):
    """A batch-2 prefill (mixtral's 20-token prompt wraps its 16-row ring)
    and three lockstep decode steps: logits at ATOL."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    prompts = np.stack(_prompts(6, (20, 20)))
    lg_j, c_j = mj.prefill(params_j, jnp.asarray(prompts), MAX_LEN)
    with ops.use(softmax="pallas"):
        lg_t, c_t = mt.prefill(params_t, torch.as_tensor(prompts), MAX_LEN)
        assert set(c_t["layers"]) == {"k", "v"}  # a bare prefill carries no counts
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
        step_j = jax.jit(mj.decode_step)
        rng = np.random.default_rng(7)
        for _ in range(3):
            tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
            lg_j, c_j = step_j(params_j, c_j, jnp.asarray(tok))
            lg_t, _ = mt.decode_step(params_t, c_t, torch.as_tensor(tok))
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)


def test_chunked_prefill_drops_what_the_monolithic_prefill_drops(pairs):
    """capacity_factor 0.5: experts overflow.  A 24-token prompt prefilled in
    chunks of 8 with the whole prompt's capacity and the carried counts
    gives the monolithic prefill's logits, K/V rows and counts, in both
    packages; chunks at their own capacity do not."""
    cfg_j, params_j, cfg_t, params_t = pairs["granite_moe_1b_a400m"]
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=0.5)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=0.5)
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    prompt = _prompts(8, (24,))[0][None]
    cap = mt.moe_prefill_capacity(24)
    assert cap == mj.moe_prefill_capacity(24) == 3
    assert build_model(get_smoke_config("granite_8b")).moe_prefill_capacity(24) is None

    lg_j, mono_j = mj.prefill(params_j, jnp.asarray(prompt), MAX_LEN, cache_t=32,
                              moe_capacity=cap)
    ch_j = None
    for s in range(0, 24, 8):
        part = jnp.asarray(prompt[:, s:s + 8])
        if ch_j is None:
            clg_j, ch_j = mj.prefill(params_j, part, MAX_LEN, cache_t=32, moe_capacity=cap)
        else:
            clg_j, ch_j = mj.prefill_extend(params_j, ch_j, part, moe_capacity=cap)
    np.testing.assert_allclose(np.asarray(clg_j), np.asarray(lg_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.asarray(ch_j["layers"]["moe"]),
                                  np.asarray(mono_j["layers"]["moe"]))

    with ops.use(softmax="pallas"):
        lg_t, mono_t = mt.prefill(params_t, torch.as_tensor(prompt), MAX_LEN, cache_t=32,
                                  moe_capacity=cap)
        outs = {}
        for name, c in (("global", cap), ("per chunk", None)):
            ch = None
            for s in range(0, 24, 8):
                part = torch.as_tensor(prompt[:, s:s + 8])
                if ch is None:
                    clg, ch = mt.prefill(params_t, part, MAX_LEN, cache_t=32,
                                         moe_capacity=c if c is not None else
                                         L.moe_capacity(cfg_t, 8))
                else:
                    clg, ch = mt.prefill_extend(params_t, ch, part, moe_capacity=c)
            outs[name] = (clg, ch)
    clg, ch = outs["global"]
    counts = mono_t["layers"]["moe"]
    assert counts.shape == (cfg_t.num_layers, 1, cfg_t.num_experts)
    assert int(counts.max()) > cap  # the prompt overflows its experts
    assert torch.equal(ch["layers"]["moe"], counts)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(mono_j["layers"]["moe"]))
    np.testing.assert_allclose(clg.numpy(), lg_t.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(ch["layers"][name][:, :, :24].numpy(),
                                   mono_t["layers"][name][:, :, :24].numpy(), atol=1e-5, rtol=0)
    assert not torch.allclose(outs["per chunk"][0], lg_t, atol=1e-3)  # the property bites


def test_finalize_ring_cache_drops_the_counts(pairs):
    _, _, cfg_t, params_t = pairs["mixtral_8x22b"]
    mt = build_model(cfg_t)
    prompt = torch.as_tensor(_prompts(9, (20,))[0])[None]
    _, staged = mt.prefill(params_t, prompt, MAX_LEN, cache_t=32,
                           moe_capacity=mt.moe_prefill_capacity(20))
    assert "moe" in staged["layers"]
    ring = mt.finalize_ring_cache(staged, 16)
    assert set(ring["layers"]) == {"k", "v"} and ring["layers"]["k"].shape[2] == 16


# ---------------------------------------------------------------------------
# engines: greedy tokens against the JAX engines


def _serve_both(pairs, arch, prompts, gens, stagger=False, **kw):
    """The same greedy workload through the JAX engine and the port's, the
    requests arriving together or (``stagger``) two up front and one after
    each of the next two ticks."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]

    def drive(eng):
        if not stagger:
            return eng.serve(prompts, gens)
        uids = [eng.submit(prompts[0], gens[0]), eng.submit(prompts[1], gens[1])]
        for p, g in zip(prompts[2:], gens[2:]):
            eng.step()
            uids.append(eng.submit(p, g))
        done = eng.run()
        return [done[u] for u in uids]

    want = drive(JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN, **kw)))
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, **kw), device="cpu")
        got = drive(eng)
    return got, want, eng


GRANITE_PATHS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_block_size=4),
    "chunked_prefix": dict(kv_layout="paged", kv_block_size=4, prefill_chunk_tokens=8,
                           prefix_cache=True),
}


@pytest.mark.parametrize("path", list(GRANITE_PATHS))
def test_granite_moe_tokens_match_the_jax_engine(path, pairs):
    prompts, gens = _prompts(10, (11, 19, 5, 14)), [5, 7, 4, 6]
    got, want, eng = _serve_both(pairs, "granite_moe_1b_a400m", prompts, gens,
                                 **GRANITE_PATHS[path])
    assert got == want
    assert eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks
    assert eng.prefix is None  # MoE archs opt out of sharing
    if path == "chunked_prefix":
        assert eng._chunked and eng.kv_stats()["prefix"] == {
            "hits": 0, "tokens_saved": 0, "evicted": 0, "nodes": 0}


RING_PATHS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_block_size=4),
    "dense_chunked": dict(kv_layout="dense", prefill_chunk_tokens=8),
    "paged_chunked_prefix": dict(kv_layout="paged", kv_block_size=4, prefill_chunk_tokens=8,
                                 prefix_cache=True),
}


@pytest.mark.parametrize("path", list(RING_PATHS))
def test_mixtral_ring_tokens_match_the_jax_engine(path, pairs):
    """Staggered arrivals of prompts (20, 11, 18, 3) on 16-row rings under
    ``max_len`` 40, generations past the first lap (mirrors
    ``tests/test_serve.py::test_continuous_greedy_parity_staggered``)."""
    prompts, gens = _prompts(11, RING_LENS), [14, 9, 12, 5]
    got, want, eng = _serve_both(pairs, "mixtral_8x22b", prompts, gens, stagger=True,
                                 **RING_PATHS[path])
    assert got == want and eng._ring and eng.prefix is None


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_matches_the_jax_serve_engine(arch, pairs):
    """Mirrors ``tests/test_serve.py::test_serve_moe_and_ssm``; mixtral's
    9-token prompts and 12 steps wrap its ring."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    prompts = np.stack(_prompts(12, (9, 9, 9)))
    want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)
                                  ).generate(jnp.asarray(prompts), 12)
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info = eng.generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info == info_j
    assert (eng.graphs.entries(), eng.graphs.replays) == (1, 11)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_opts_out_for_moe_as_the_reference(arch, pairs):
    """Mirrors ``tests/test_prefix_cache.py::test_prefix_cache_opt_outs_and_validation``."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    kw = dict(num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4,
              prefix_cache=True)
    eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(**kw), device="cpu")
    ref = JaxEngine(cfg_j, params_j, JaxConfig(**kw))
    assert eng.prefix is None and ref.prefix is None and eng._chunked
    assert eng.kv_stats()["prefix"] == ref.kv_stats()["prefix"]


# ---------------------------------------------------------------------------
# capture: no host reads in the MoE decode step


def _no_host_read(*args, **kwargs):
    raise AssertionError("host read or upload during capture")


class NoHostReadGraph:
    """A stand-in capture object: the step records once with
    ``Tensor.item`` / ``tolist``, ``torch.cuda.synchronize`` and uploads of
    host data (``torch.tensor``, ``torch.as_tensor`` of a non-tensor) made to
    raise: what a CUDA graph cannot capture."""

    def __init__(self, device, stream):
        pass

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        real_as_tensor = torch.as_tensor

        def as_tensor(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                _no_host_read()
            return real_as_tensor(data, *args, **kwargs)

        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(torch.Tensor, "item", _no_host_read)
            mp.setattr(torch.Tensor, "tolist", _no_host_read)
            mp.setattr(torch.cuda, "synchronize", _no_host_read)
            mp.setattr(torch, "tensor", _no_host_read)
            mp.setattr(torch, "as_tensor", as_tensor)
            self.outputs = fn()
        finally:
            mp.undo()

    def replay(self):
        return self.outputs


@pytest.mark.parametrize("layout", ["dense", "paged", "lockstep"])
def test_moe_decode_step_captures_without_host_reads(layout, monkeypatch):
    """The MoE tick (dense and paged) and the lockstep step record through
    the stand-in capture at temperature 0.8 (the STAR sampling softmax in
    the step too); a sync or upload in the dispatch would raise."""
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 1, "cpu")
    monkeypatch.setattr(engine_mod, "StepGraphs", lambda dev: graph_mod.StepGraphs(
        dev, graph_factory=NoHostReadGraph))
    prompts = _prompts(13, (6, 9))
    with ops.use(softmax="pallas"):
        if layout == "lockstep":
            eng = ServeEngine(cfg, params, ServeConfig(max_len=MAX_LEN, temperature=0.8),
                              device="cpu")
            out, _ = eng.generate(np.stack([prompts[0], prompts[0]]), 4)
            assert out.shape == (2, 4) and eng.graphs.entries() == 1
        else:
            eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
                num_slots=2, max_len=MAX_LEN, kv_layout=layout, temperature=0.8),
                device="cpu")
            assert [len(o) for o in eng.serve(prompts, [3, 4])] == [3, 4]
            assert eng.graph_entries() == 1
    with pytest.raises(AssertionError, match="host read"):  # the stand-in does bite
        NoHostReadGraph(None, None).capture(lambda: torch.zeros(2).item())


# ---------------------------------------------------------------------------
# the launcher


@pytest.mark.parametrize("arch,argv,expect", [
    ("granite_moe_1b_a400m", [], "generated (4, 6)"),
    ("granite_moe_1b_a400m", ["--engine", "continuous", "--kv-layout", "paged",
                              "--prefix-cache", "--prefill-chunk-tokens", "8"], "kv=paged"),
    ("mixtral_8x22b", ["--engine", "continuous"], "kv=dense"),
])
def test_launcher_serves_the_moe_archs(arch, argv, expect, capsys):
    rc = launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                        "--prompt-len", "12", "--gen", "6", "--softmax-impl", "pallas",
                        "--attn-impl", "pallas", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert expect in out


# ---------------------------------------------------------------------------
# the router softmax: the kernel's order of the row sum


def _sum_like_the_kernel(p: np.ndarray, x_itemsize: int) -> np.ndarray:
    """Scalar float32 emulation of the kernel's denominator, one addition
    at a time (``csrc/star_softmax_lut.cu``: per-thread chunks, warp and
    CTA butterflies, ranks in order)."""
    nt, v = 256, 16 // x_itemsize
    rows, d = p.shape
    c = sk.cluster_size(d)
    s = sk.slice_len(d, c)
    out = np.zeros(rows, np.float32)
    for r in range(rows):
        den = np.float32(0)
        for q in range(c):
            sl = p[r, q * s:min(d, (q + 1) * s)]
            part = np.zeros(nt, np.float32)
            for tid in range(nt):
                for g in range(-(-s // (nt * v))):
                    for e in range(v):
                        i = (g * nt + tid) * v + e
                        if i < len(sl):
                            part[tid] = np.float32(part[tid] + sl[i])
            lanes = part.reshape(nt // 32, 32)
            for o in (16, 8, 4, 2, 1):
                lanes = (lanes[:, :o] + lanes[:, o:2 * o]).astype(np.float32)
            warps = lanes[:, 0]
            for o in (4, 2, 1):
                warps = (warps[:o] + warps[o:2 * o]).astype(np.float32)
            den = np.float32(den + warps[0])
        out[r] = den
    return out


@pytest.mark.parametrize("rows,d", [(3, 32), (2, 4), (1, 17), (2, 4097), (1, 9000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_row_sum_takes_the_kernels_order(rows, d, dtype):
    p = torch.rand(rows, d, generator=torch.Generator().manual_seed(d))
    got = sk.kernel_order_sum(p, dtype)
    assert got.shape == (rows, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), _sum_like_the_kernel(p.numpy(),
                                                                           dtype.itemsize))
    x = (torch.randn(rows, d, generator=torch.Generator().manual_seed(d)) * 4).to(dtype)
    probs = sk.star_softmax_ref(x, FMT)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


ROUTER_SHAPES = [(512, 32), (4, 32), (64, 4)]  # a 512-token prefill, a 4-slot tick, mixtral


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROUTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_softmax_kernel_bit_equal_to_plain_on_card(cuda, shape, dtype):
    """One CTA a row (``cluster_size(32) == 1``): the kernel's probabilities
    equal its plain version's bit for bit, and their top-k experts too."""
    assert sk.cluster_size(shape[1]) == 1
    x = (torch.randn(*shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
         * 4).to(dtype)
    reset_launch_counts()
    got = sk.star_softmax_kernel(x, FMT)
    assert launch_counts()["star_softmax"] == 1
    want = sk.star_softmax_ref(x, FMT)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), sk.star_softmax_ref(x.cpu(), FMT))
    k = min(8, shape[1])
    assert torch.equal(L.top_k(got, k)[1], L.top_k(want, k)[1])


@pytest.mark.cuda
def test_moe_tick_replay_equals_the_eager_tick_on_card(cuda):
    """The granite-moe smoke tick on the dense and paged layouts: the
    replayed tick's logits and greedy tokens equal the eager tick's from a
    copy of the same state, the pool it leaves equals the eager copy's, the
    router kernel launches once per layer of every prefill and tick, and
    the served tokens equal the CPU's."""
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    gpu = tree_map(lambda t: t.cuda(), params)
    prompts = _prompts(14, (9, 6, 13))
    for layout in ("dense", "paged"):
        kw = dict(num_slots=2, max_len=MAX_LEN, kv_layout=layout, kv_block_size=4)
        with ops.use(softmax="pallas"):
            eng = ContinuousBatchingEngine(cfg, gpu, ContinuousConfig(**kw), device="cuda")
            for p in prompts[:2]:
                eng.submit(p, 20)
            for _ in range(3):
                eng.step()
            eng._upload_tick_inputs()
            state = [None if t is None else tree_map(torch.clone, t) for t in eng._tick_state()]
            out_e, last_e = eng._tick_body(*state)
            out_r, last_r = eng._decode()
            torch.cuda.synchronize()
            assert torch.equal(last_r, last_e) and torch.equal(out_r, out_e)
            for name, leaf in eng.pool["layers"].items():
                assert torch.equal(leaf, state[0]["layers"][name]), name
            outs = {}
            for dev, p in (("cuda", gpu), ("cpu", params)):
                e = ContinuousBatchingEngine(cfg, p, ContinuousConfig(**kw), device=dev)
                reset_launch_counts()
                outs[dev] = e.serve(prompts, [5, 4, 6])
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert e.graph_entries() == 1 and e.graphs.replays == e.ticks
                    assert launch_counts()["star_softmax"] == cfg.num_layers * (
                        len(prompts) + e.ticks)
        assert outs["cuda"] == outs["cpu"], layout


@pytest.mark.cuda
@pytest.mark.parametrize("g,t", [(1, 2048), (64, 1)])  # a monolithic prefill, the decode tick
def test_the_index_route_matches_the_one_hot_oracle_on_card(cuda, g, t, monkeypatch):
    """granite-moe-1b-a400m's block at full width in bfloat16, the STAR
    router on the kernel: the experts' queues and the counts bit-equal to
    the one-hot form's, and the output within one bfloat16 step of it on
    at least 99.9 % of entries (the k rows are added in another order)."""
    cfg = get_config("granite_moe_1b_a400m")
    p = materialize(L.spec_moe(cfg), 27, cuda)
    x = torch.randn(g, t, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(28)).to(torch.bfloat16)
    cap = L.moe_capacity(cfg, t)
    with torch.no_grad(), ops.use(softmax="pallas"):
        y, counts, xin = _routed(p, x, cfg, monkeypatch, capacity=cap)
        y_o, counts_o, xin_o = moe_one_hot(p, x, cfg, capacity=cap)
    assert y.dtype == y_o.dtype == torch.bfloat16
    assert torch.equal(xin, xin_o) and torch.equal(counts, counts_o)
    step = torch.ldexp(torch.ones_like(y_o, dtype=torch.float32),
                       torch.frexp(y_o.float()).exponent - 8)  # one bfloat16 step at y_o
    within = (y.float() - y_o.float()).abs() <= step
    assert float(within.float().mean()) >= 0.999
