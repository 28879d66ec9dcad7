"""Whole runs on the CPU at a tiny size, the look for a chip skipped: a
sound run is correct, and each fault a serving cell can have, planted in
the timed path, turns ``correct`` false.  The control (the reference in
fp8) reads above the limits the program keeps.  Every answer that
finished in the window is checked."""
import copy
import time

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests._tiny import bench, overrides

# limits for the tiny float32 models, where the port and the reference agree to rounding
LIMITS = {"logit_gap_max": {"limit": 1e-3}, "logit_gap_mean": {"limit": 1e-4}}
CELLS = ["dsmoe16b.chat", "mamba2.longdoc"]


@pytest.fixture(autouse=True)
def one_thread():
    """One thread a worker, so that the window holds finished answers
    however many test workers share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(cell, fault=None, control=False):
    return run_cell(bench(), cell, 2**32 + 5, 3.0, False, device=torch.device("cpu"),
                    t_process=time.perf_counter(), overrides=overrides(cell, LIMITS),
                    fault=fault, control=control, log=lambda *a: None)


def _wrap_decode(fn):
    def fault(server, model):
        inner = model.decode_step
        model.decode_step = lambda tokens, caches, pos: fn(inner, tokens, caches, pos)
    return fault


def _state_unchanged(inner, tokens, caches, pos):
    """The decode step computes on a copy and hands back the caches unchanged."""
    logits, _ = inner(tokens, copy.deepcopy(caches), pos)
    return logits, caches


def _half_batch(inner, tokens, caches, pos):
    """The second half of the slots is left out: its logits are the first half's."""
    logits, caches = inner(tokens, caches, pos)
    half = logits.shape[0] // 2
    logits = logits.clone()
    logits[half:2 * half] = logits[:half]
    return logits, caches


def _token_altered(inner, tokens, caches, pos):
    """A token is altered where it is produced: slot 0 takes its worst token."""
    logits, caches = inner(tokens, caches, pos)
    logits = logits.clone()
    logits[0] = -logits[0]
    return logits, caches


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_reads_above_it(cell):
    res = _run(cell, control=True)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert list(res)[-1] == "checks"
    assert checks["control_gap_max"]["value"] > LIMITS["logit_gap_max"]["limit"]
    assert checks["control_gap_mean"]["value"] > LIMITS["logit_gap_mean"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(cell, fault):
    res = _run(cell, fault=_wrap_decode(fault))
    assert not res["correct"], res["checks"]
