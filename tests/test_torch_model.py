"""The port's DecoderLM against the JAX reference with the same weights.

Weights come from the reference's parameter pytree through numpy
(``from_reference``); the reference runs with ``attn_impl="pallas"``
(flash_star prefill in interpret mode, ``pallas_paged`` decode), the port
with the same config on the CPU, where each kernel wrapper runs its plain
version.  Logits hold to ``atol=1e-4`` at float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.param import materialize as jax_materialize
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.models.param import from_reference
from repro_torch.models.registry import build_model

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    model_j = jax_build_model(cfg_j)
    params_j = jax_materialize(model_j.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params_j)
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(np_params, cfg_t, device="cpu")
    return cfg_j, model_j, params_j, np_params, cfg_t, build_model(cfg_t), params_t


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_from_reference_round_trip(pair):
    _, _, _, np_params, cfg_t, model_t, params_t = pair
    ref = dict(_leaves(np_params))
    got = dict(_leaves(params_t))
    specs = dict(_leaves(model_t.param_specs()))
    assert sorted(ref) == sorted(got) == sorted(specs)
    for path, arr in ref.items():
        t = got[path]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert tuple(t.shape) == specs[path].shape == arr.shape, path
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=path)


def test_from_reference_needs_a_device_or_cuda(pair, monkeypatch):
    _, _, _, np_params, cfg_t, _, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(np_params, cfg_t)


def test_prefill_logits_and_cache_match_reference(pair):
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_t.vocab_size, (1, 11)).astype(np.int32)
    logits_j, cache_j = model_j.prefill(params_j, jnp.asarray(tokens), 16)
    logits_t, cache_t = model_t.prefill(params_t, torch.as_tensor(tokens), 16)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t["layers"][name].numpy(),
                                   np.asarray(cache_j["layers"][name]), atol=ATOL, rtol=0)
    assert int(cache_t["len"]) == int(cache_j["len"]) == 11


def test_forward_matches_reference(pair):
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    tokens = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, 9)).astype(np.int32)
    ref = np.asarray(model_j.forward(params_j, jnp.asarray(tokens)))
    got = model_t.forward(params_t, torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_paged_decode_steps_match_reference(pair):
    """Two slots with ragged prompts (5 and 11 rows, bs=4) decode three
    steps through the paged pool in both packages; a free third slot rides
    along on the scratch block."""
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    rng = np.random.default_rng(5)
    bs, w, slots = 4, 5, 3
    cache_t_rows = w * bs
    num_blocks = slots * w + 1
    pool_j = model_j.init_paged_cache(num_blocks, bs, slots)
    pool_t = model_t.init_paged_cache(num_blocks, bs, slots, device="cpu")
    tables = np.zeros((slots, w), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    for slot, plen in ((0, 5), (1, 11)):
        prompt = rng.integers(0, cfg_t.vocab_size, (1, plen)).astype(np.int32)
        tables[slot] = perm[slot * w:(slot + 1) * w]
        _, c_j = model_j.prefill(params_j, jnp.asarray(prompt), cache_t_rows)
        _, c_t = model_t.prefill(params_t, torch.as_tensor(prompt), cache_t_rows)
        pool_j = model_j.write_slot_paged(pool_j, c_j, slot, jnp.asarray(tables[slot]))
        model_t.write_slot_paged(pool_t, c_t, slot, torch.as_tensor(tables[slot]))
    for _ in range(3):
        tok = rng.integers(0, cfg_t.vocab_size, (slots, 1)).astype(np.int32)
        lg_j, pool_j = model_j.decode_step_paged(
            params_j, pool_j, jnp.asarray(tok), jnp.asarray(tables), cache_t=cache_t_rows)
        lg_t, pool_t = model_t.decode_step_paged(
            params_t, pool_t, torch.as_tensor(tok), torch.as_tensor(tables),
            cache_t=cache_t_rows)
        for slot in (0, 1):  # slot 2 is free: its output is discarded
            np.testing.assert_allclose(lg_t[slot].numpy(), np.asarray(lg_j[slot]),
                                       atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pool_t["len"].numpy(), np.asarray(pool_j["len"]))
