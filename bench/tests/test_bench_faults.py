"""The comparison that decides ``correct`` sees faults of the timed path: a
whole run of a cell at toy widths on the CPU (the look for a card skipped),
with the program broken underneath, comes out not correct; unbroken, it
comes out correct.  The serving cells can have two of the faults: a token
altered where it is produced, and a decode step that leaves its state (the
KV cache) unchanged.  Half a batch left out and the exchange between chips
concern training and several chips, which no cell has."""

import time

import pytest
import torch

from _tiny import tiny_cell
import faults  # noqa: E402  (bench/ is on the path once _tiny is imported)
from harness.runner import execute


def _run(moe, seed=11):
    line, rows, _, _ = execute(tiny_cell(moe), seed, 0.5, False, torch.device("cpu"),
                               time.perf_counter())
    return line


@pytest.mark.parametrize("moe", [False, True])
def test_sound_run_is_correct(moe):
    line = _run(moe)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("moe", [False, True])
def test_a_token_altered_where_produced_is_caught(moe):
    with faults.altered_token():
        line = _run(moe)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("moe", [False, True])
def test_a_decode_step_that_keeps_its_state_is_caught(moe):
    """The tick's K/V write is undone: every decode step leaves the pool as
    it was."""
    with faults.stale_kv():
        line = _run(moe)
    assert not line["correct"], line["checks"]
