"""The benchmark's plain reference against the port's CPU path at toy widths:
its STAR softmax bit for bit, and its logits (dense and MoE, float32)."""

import pytest
import torch

from _tiny import tiny_config  # noqa: F401  (puts src/ and bench/ on the path)
from harness.driver import draw_weights, model_config
from reference import common
from reference import model as ref_model
from reference.star import star_softmax


@pytest.mark.parametrize("where", [False, True])
def test_star_copy_matches_the_port(where):
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.star_softmax import star_softmax as port_star

    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 300, generator=g) * 8
    x[0, :5] = -1e30
    mask = torch.rand(6, 300, generator=g) > 0.3 if where else None
    want = port_star(x, FixedPointFormat(6, 2), mode="gather", where=mask)
    assert torch.equal(star_softmax(x, 6, 2, where=mask), want)


@pytest.mark.parametrize("moe", [False, True])
def test_reference_logits_match_the_port(moe):
    from repro_torch.models.registry import build_model

    conf = tiny_config(moe)
    cfg = model_config(conf)
    weights = draw_weights(cfg, 7, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (40,), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = build_model(cfg).forward(weights, tokens[None])[0].float()
    rows = torch.arange(40)
    got = ref_model.logits(weights, conf["model"], (6, 2), tokens, 40, rows)
    assert got.shape == want.shape
    live = slice(0, cfg.vocab_size)
    assert torch.allclose(got[:, live], want[:, live], atol=1e-4, rtol=1e-4)
    assert bool((got[:, cfg.vocab_size:] == ref_model.MASKED_LOGIT).all())


def test_reference_generated_rows_drop_nothing():
    """Rows past the prompt are each a group of one in the program's decode:
    no capacity drop.  A prompt of all 40 rows drops some choices (capacity
    int(1.25 * 2 * 40 / 8) = 12 of 80), so its logits differ there."""
    conf = tiny_config(True)
    cfg = model_config(conf)
    weights = draw_weights(cfg, 3, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (40,), generator=torch.Generator().manual_seed(2))
    rows = torch.arange(40)
    whole = ref_model.logits(weights, conf["model"], (6, 2), tokens, 40, rows)
    short = ref_model.logits(weights, conf["model"], (6, 2), tokens, 10, rows)
    assert torch.equal(whole[:1], short[:1])  # the first row is never dropped
    assert not torch.allclose(whole, short)


def test_float8_control_rounds():
    x = torch.randn(5, 7)
    w = torch.randn(7, 3)
    assert torch.equal(common.FLOAT32.mm(x, w), x @ w)
    got = common.FLOAT8.mm(x, w)
    assert not torch.equal(got, x @ w)
    assert torch.allclose(got, x @ w, atol=0.5)
    # a product's operand holds at most 2**8 distinct magnitudes; what the
    # program holds is bfloat16
    assert common.FLOAT8.operand(torch.randn(10000)).abs().unique().numel() <= 256
    held = common.FLOAT8.held(torch.randn(10000))
    assert torch.equal(held, held.bfloat16().float())
    assert held.abs().unique().numel() > 256
