"""The VLM family (qwen2-vl-7b's smoke config: M-RoPE and the stub patch
prefix) against the JAX reference with the same weights and inputs.

Weights and inputs come from seeds through numpy (``from_reference``; the
patch embeddings are numpy arrays handed to both).  The JAX side keeps its
default routes (attention ``xla``, softmax ``reference``); the port runs
``attn_impl="pallas"`` under ``ops.use(softmax="pallas")``, so attention
and sampling go through the kernel wrappers, which run their plain versions
on the CPU.  Tolerances: ``apply_mrope`` within 2e-6 of the largest
|output| (float32 ``cos`` / ``sin`` of two libraries, a few ulps apart at
the large angles M-RoPE's streams reach); logits at ``atol=1e-4`` (float32
sums in another order); the cache's ``len`` and ``pos``, and greedy tokens,
identical.  Mirrors the reference's VLM tests
(``tests/test_paged_kv.py::test_paged_vlm_mrope_parity``,
``tests/test_paged_kernel.py::test_engine_vlm_mrope_parity_pallas_paged``,
``tests/test_kv_quant.py::test_engine_int8_vlm_mrope_parity``,
``tests/test_decode_parity.py``, ``tests/test_prefix_cache.py::
test_chunked_prefill_parity_vlm_mrope``).

The ``cuda`` test holds the smoke tick's replay bit-equal to its eager tick
with VLM requests in the pool, and the card's tokens to the CPU's; it skips
where there is no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as L
from repro_torch.models.param import compute_params, count_params, from_reference, tree_map
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

ARCH = "qwen2_vl_7b"
ATOL = 1e-4  # logits
MROPE_RTOL = 2e-6  # of the largest |output|: cos / sin of two float32 libraries
MAX_LEN = 48


@pytest.fixture(scope="module")
def pair():
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    cfg_j = jax_smoke_config(ARCH)
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config(ARCH), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                              device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _patches(seed, n, batch=1):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the config


def test_config_follows_the_reference(jax_ref):
    """Both configs field for field (the reference's sharding / training
    fields aside), the published widths and the parameter count (7.62 B)
    of both packages; sections that do not sum to head_dim // 2 are
    refused."""
    assert ARCH in ARCH_IDS
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
            full.vocab_size, full.resolved_head_dim) == (28, 3584, 28, 4, 18944, 152064, 128)
    assert (full.mrope_sections, full.num_patches, full.frontend_dim) == ((16, 24, 24), 256, 1280)
    n = count_params(build_model(full).param_specs())
    assert n == jax_count_params(jax_build_model(jax_config(ARCH)).param_specs())
    assert 7.5e9 < n < 7.7e9
    with pytest.raises(ValueError, match="must sum to head_dim // 2"):
        dataclasses.replace(get_smoke_config(ARCH), mrope_sections=(4, 2, 3)).validate()
    assert isinstance(build_model(get_smoke_config(ARCH)), DecoderLM)


def test_patch_proj_comes_across_and_is_cast_once(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    got = params_t["patch_proj"]["kernel"]
    assert tuple(got.shape) == (cfg_t.frontend_dim, cfg_t.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(params_j["patch_proj"]["kernel"]))
    bf16 = dataclasses.replace(cfg_t, compute_dtype="bfloat16")
    assert compute_params(params_t, bf16)["patch_proj"]["kernel"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# M-RoPE


@pytest.mark.parametrize("d,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(d, sections, jax_ref):
    """Patch-like (t, h, w) ids and text ids past them, at qwen2-vl's theta."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 40, 3, d)).astype(np.float32)
    side = 6
    p = np.arange(36)
    patch = np.stack([np.zeros_like(p), p // side, p % side], -1)
    text = side + np.arange(4)
    pos = np.concatenate([patch, np.stack([text] * 3, -1)])[None].repeat(2, 0).astype(np.int32)
    pos[1] += 1000  # large angles
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    got = L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6, sections).numpy()
    np.testing.assert_allclose(got, want, atol=MROPE_RTOL * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="must sum to head_dim // 2"):
        L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6, (1, 2, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_streams_is_the_1d_rope_bit_for_bit(dtype):
    """Every text row and decode step: the same angles through the same cos
    and sin, so the captured tick's arithmetic does not change."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 9, 4, 128, generator=g).to(dtype)
    pos = torch.randint(0, 70000, (3, 9), generator=g, dtype=torch.int32)
    streams = torch.stack([pos, pos, pos], -1)
    assert torch.equal(L.apply_mrope(x, streams, 1e6, (16, 24, 24)), L.apply_rope(x, pos, 1e6))
    cfg = get_smoke_config(ARCH)
    q, k = L.rotate(x[..., :16], x[..., :16], streams, cfg)
    assert torch.equal(q, L.apply_rope(x[..., :16], pos, cfg.rope_theta))
    # a 3-D position on a config without sections uses stream 0
    dense = get_smoke_config("granite_8b")
    q, _ = L.rotate(x[..., :16], x[..., :16], torch.stack([pos, pos + 1, pos + 2], -1), dense)
    assert torch.equal(q, L.apply_rope(x[..., :16], pos, dense.rope_theta))


# ---------------------------------------------------------------------------
# the model against JAX


def test_forward_and_prefill_with_patches_match_jax(pair):
    """Logits of the whole sequence (patches included) and of the prefill;
    the cache's ``len`` is ``P + T`` and ``pos`` ``side + T``, exactly."""
    cfg_j, params_j, cfg_t, params_t = pair
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    tokens = np.stack(_prompts(4, (13, 13)))
    pe = _patches(5, 1, batch=2)[0]
    with ops.use(softmax="pallas"):
        got = mt.forward(params_t, torch.as_tensor(tokens), patch_embeds=torch.as_tensor(pe))
        lg_t, c_t = mt.prefill(params_t, torch.as_tensor(tokens), MAX_LEN, patch_embeds=pe)
    want = mj.forward(params_j, jnp.asarray(tokens), patch_embeds=jnp.asarray(pe))
    assert got.shape == (2, cfg_t.num_patches + 13, cfg_t.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    lg_j, c_j = mj.prefill(params_j, jnp.asarray(tokens), MAX_LEN, patch_embeds=jnp.asarray(pe))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
    side = int(cfg_t.num_patches ** 0.5)
    assert int(c_t["len"]) == int(c_j["len"]) == cfg_t.num_patches + 13
    assert int(c_t["pos"]) == int(c_j["pos"]) == side + 13
    rows = cfg_t.num_patches + 13
    for name in ("k", "v"):
        np.testing.assert_allclose(c_t["layers"][name][:, :, :rows].numpy(),
                                   np.asarray(c_j["layers"][name])[:, :, :rows], atol=ATOL, rtol=0)


def test_prefill_extend_and_decode_steps_match_jax(pair):
    """A patch prefill in a staging cache, a text chunk through
    ``prefill_extend`` (continuing from ``pos``), then three lockstep decode
    steps with three equal streams: logits at ATOL, ``len`` / ``pos``
    exact."""
    cfg_j, params_j, cfg_t, params_t = pair
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    tokens = _prompts(6, (12,))[0][None]
    pe = _patches(7, 1)[0]
    lg_j, c_j = mj.prefill(params_j, jnp.asarray(tokens[:, :8]), MAX_LEN, cache_t=MAX_LEN,
                           patch_embeds=jnp.asarray(pe))
    lg_j, c_j = mj.prefill_extend(params_j, c_j, jnp.asarray(tokens[:, 8:]))
    with ops.use(softmax="pallas"):
        lg_t, c_t = mt.prefill(params_t, torch.as_tensor(tokens[:, :8]), MAX_LEN,
                               cache_t=MAX_LEN, patch_embeds=pe)
        lg_t, c_t = mt.prefill_extend(params_t, c_t, torch.as_tensor(tokens[:, 8:]))
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
        assert (int(c_t["len"]), int(c_t["pos"])) == (int(c_j["len"]), int(c_j["pos"]))
        rng = np.random.default_rng(8)
        for _ in range(3):
            tok = rng.integers(0, 256, (1, 1)).astype(np.int32)
            lg_j, c_j = mj.decode_step(params_j, c_j, jnp.asarray(tok))
            lg_t, _ = mt.decode_step(params_t, c_t, torch.as_tensor(tok))
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
        assert (int(c_t["len"]), int(c_t["pos"])) == (int(c_j["len"]), int(c_j["pos"]))


# ---------------------------------------------------------------------------
# engines: greedy tokens against the JAX engines


def test_lockstep_with_patches_matches_the_jax_serve_engine(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    prompts = np.stack(_prompts(9, (9, 9)))
    pe = _patches(10, 1, batch=2)[0]
    want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)).generate(
        jnp.asarray(prompts), 10, patch_embeds=jnp.asarray(pe))
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info = eng.generate(prompts, 10, patch_embeds=pe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info == info_j == {"cache_len": cfg_t.num_patches + 9 + 9}
    with pytest.raises(ValueError, match="prefix 16"):
        eng.generate(prompts, MAX_LEN - 9 - 16 + 2, patch_embeds=pe)


def _serve_both(pair, requests, **kw):
    """``requests``: (prompt, new tokens, patch embeddings or None) through
    the JAX engine and the port's, in waves (each wave submitted, then
    drained).  Returns (port tokens, JAX tokens, port engine, JAX engine)."""
    cfg_j, params_j, cfg_t, params_t = pair

    def drive(eng, waves):
        out = []
        for wave in waves:
            uids = [eng.submit(p, g, **({} if e is None else {"patch_embeds": e}))
                    for p, g, e in wave]
            done = eng.run()
            out += [done[u] for u in uids]
        return out

    waves = requests if isinstance(requests[0], list) else [requests]
    jeng = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN, **kw))
    want = drive(jeng, [[(p, g, None if e is None else jnp.asarray(e)) for p, g, e in w]
                        for w in waves])
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, **kw), device="cpu")
        got = drive(eng, waves)
    return got, want, eng, jeng


PATHS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_block_size=4),
    "paged_int8": dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8"),
    "dense_chunked": dict(kv_layout="dense", prefill_chunk_tokens=6),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_with_patches_matches_jax(path, pair):
    prompts, gens = _prompts(11, (5, 9, 7)), [3, 4, 5]
    pe = _patches(12, 3)
    got, want, eng, _ = _serve_both(pair, list(zip(prompts, gens, pe)), **PATHS[path])
    assert got == want
    assert eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks
    assert not eng._frontend  # kept until each request finished


def test_chunked_prefix_mixed_load_matches_jax(pair):
    """Text-only requests with a common 12-token prefix share it through the
    trie; VLM requests on the same engine never look it up or insert (their
    rows sit past the token grid); tokens and trie counters as the
    reference's, 6-token chunks."""
    cfg_j, params_j, cfg_t, params_t = pair
    rng = np.random.default_rng(13)
    pre = rng.integers(0, 256, (12,)).astype(np.int32)
    text = [np.concatenate([pre, rng.integers(0, 256, (n,)).astype(np.int32)]) for n in (3, 5)]
    vlm = _prompts(14, (12, 12))
    pe = _patches(15, 2)
    waves = [[(text[0], 4, None), (vlm[0], 3, pe[0])],
             [(text[1], 5, None), (vlm[1], 4, pe[1])]]
    kw = dict(kv_layout="paged", kv_block_size=4, prefix_cache=True, prefill_chunk_tokens=6)
    seen = []
    real_lookup = engine_mod.PrefixCache.lookup

    def lookup(self, tokens):
        seen.append(np.asarray(tokens).copy())
        return real_lookup(self, tokens)

    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod.PrefixCache, "lookup", lookup)
    try:
        got, want, eng, jeng = _serve_both(pair, waves, **kw)
    finally:
        mp.undo()
    assert got == want
    st = eng.kv_stats()["prefix"]
    assert st == jeng.kv_stats()["prefix"]
    assert st["hits"] >= 1 and st["tokens_saved"] >= 8  # the second text request shared
    assert len(seen) == 2 and all(len(s) in (15, 17) for s in seen)  # text requests only


def test_preemption_with_patches_matches_jax(pair):
    """A pool of 13 blocks of 4 rows cannot hold two VLM requests (16 patch
    rows each): the later one is preempted and re-prefills with its own
    patches."""
    prompts, gens = _prompts(16, (6, 8, 5)), [9, 7, 6]
    pe = _patches(17, 3)
    got, want, eng, jeng = _serve_both(pair, list(zip(prompts, gens, pe)), kv_layout="paged",
                                       kv_block_size=4, kv_pool_blocks=13)
    assert got == want
    assert eng.preemptions >= 1 and eng.preemptions == jeng.preemptions


def test_submit_counts_the_patch_rows(pair):
    """``need = P + len(prompt) + n - 1``, in the capacity check of both
    layouts, and a text-only request on the same engine still fits."""
    _, _, cfg_t, params_t = pair
    p = cfg_t.num_patches
    pe = _patches(18, 1)[0]
    for layout in ("dense", "paged"):
        eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, kv_layout=layout, kv_block_size=4), device="cpu")
        fits = MAX_LEN - p - 10 + 1
        eng.submit(np.zeros(10, np.int32), fits, patch_embeds=pe)
        with pytest.raises(ValueError, match=f"prompt 10 \\+ prefix {p} \\+ {fits + 1}"):
            eng.submit(np.zeros(10, np.int32), fits + 1, patch_embeds=pe)
        eng.submit(np.zeros(10, np.int32), fits + 1)  # no patches: no prefix rows


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
def test_vlm_decode_step_captures_without_host_reads(layout, monkeypatch, pair):
    """The tick (dense, paged) and the lockstep step with VLM requests record
    through a stand-in capture at temperature 0.8 with ``Tensor.item``,
    ``torch.cuda.synchronize`` and host uploads raising: the three M-RoPE
    streams and their band index add none."""
    _, _, cfg_t, params_t = pair
    monkeypatch.setattr(engine_mod, "StepGraphs", lambda dev: graph_mod.StepGraphs(
        dev, graph_factory=NoHostReadGraph))
    prompts, pe = _prompts(21, (6, 9)), _patches(22, 2)
    with ops.use(softmax="pallas"):
        if layout == "lockstep":
            eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN, temperature=0.8),
                              device="cpu")
            out, _ = eng.generate(np.stack([prompts[0], prompts[0]]), 4,
                                  patch_embeds=np.concatenate(pe))
            assert out.shape == (2, 4) and eng.graphs.entries() == 1
        else:
            eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
                num_slots=2, max_len=MAX_LEN, kv_layout=layout, temperature=0.8),
                device="cpu")
            uids = [eng.submit(p, g, patch_embeds=e) for p, g, e in zip(prompts, [3, 4], pe)]
            done = eng.run()
            assert [len(done[u]) for u in uids] == [3, 4]
            assert eng.graph_entries() == 1


# ---------------------------------------------------------------------------
# the launcher


@pytest.mark.parametrize("argv,expect", [
    ([], "generated (4, 6)"),
    (["--engine", "continuous"], "kv=dense"),
    (["--engine", "continuous", "--kv-layout", "paged", "--prefix-cache",
      "--prefill-chunk-tokens", "8", "--kv-dtype", "int8"], "kv=paged"),
])
def test_launcher_serves_qwen2_vl(argv, expect, capsys):
    rc = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                        "--prompt-len", "12", "--gen", "6", "--softmax-impl", "pallas",
                        "--attn-impl", "pallas", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert expect in out
    if not argv:  # the default max_len holds the patch rows: P + T + gen - 1
        assert "cache_len=33" in out


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_vlm_tick_replay_equals_the_eager_tick_on_card(cuda):
    """The qwen2-vl smoke tick with VLM requests in the pool, dense and
    paged: the replayed tick's logits equal the eager tick's from a copy of
    the same state, and the served tokens on the card equal the CPU's, with
    flash_star once per layer of every prefill."""
    from repro_torch.models.param import materialize

    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    gpu = tree_map(lambda t: t.cuda(), params)
    prompts, pe = _prompts(19, (9, 6, 13)), _patches(20, 3)
    for layout in ("dense", "paged"):
        kw = dict(num_slots=2, max_len=MAX_LEN, kv_layout=layout, kv_block_size=4)
        with ops.use(softmax="pallas"):
            eng = ContinuousBatchingEngine(cfg, gpu, ContinuousConfig(**kw), device="cuda")
            for p, e in zip(prompts[:2], pe):
                eng.submit(p, 20, patch_embeds=e)
            for _ in range(3):
                eng.step()
            eng._upload_tick_inputs()
            state = [None if t is None else tree_map(torch.clone, t) for t in eng._tick_state()]
            out_e, last_e = eng._tick_body(*state)
            out_r, last_r = eng._decode()
            torch.cuda.synchronize()
            assert torch.equal(last_r, last_e) and torch.equal(out_r, out_e)
            outs = {}
            for dev, prm in (("cuda", gpu), ("cpu", params)):
                e = ContinuousBatchingEngine(cfg, prm, ContinuousConfig(**kw), device=dev)
                reset_launch_counts()
                uids = [e.submit(p, g, patch_embeds=x)
                        for p, g, x in zip(prompts, [5, 4, 6], pe)]
                done = e.run()
                outs[dev] = [done[u] for u in uids]
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert e.graph_entries() == 1 and e.graphs.replays == e.ticks
                    assert launch_counts()["flash_star"] >= cfg.num_layers * len(prompts)
        assert outs["cuda"] == outs["cpu"], layout
