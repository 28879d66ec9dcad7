"""The port's spans and counters (``repro_torch.trace``) on a served run:
off they record nothing, on they nest as the serving loop calls, the K/V
counter follows the slots, and the served tokens do not change."""
import numpy as np
import pytest
import torch

from portbench.harness import port_arch
from portbench.tests._tiny import config
from repro_torch import trace
from repro_torch.models.model import BuildFlags, Model
from repro_torch.serve import SlotServer

ARCHS = ["dsmoe16b", "mamba2"]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _serve(name, on, per_step=None):
    """Seven requests over three slots of a tiny model; the finished
    requests' tokens by id."""
    cfg = config(name)
    flags = BuildFlags(dtype=cfg["dtype"], attn_impl=cfg["attn_impl"], ssd_impl=cfg["ssd_impl"])
    model = Model(port_arch(cfg), flags, device=torch.device("cpu"), seed=3)
    server = SlotServer(model, n_slots=3, max_len=64)
    rng = np.random.default_rng(7)
    for rid in range(7):
        server.submit(rid, rng.integers(0, cfg["vocab_size"], size=int(rng.integers(3, 30))),
                      int(rng.integers(2, 9)))
    if on:
        trace.enable()
    while server.step() or server._queue:
        if per_step is not None:
            per_step(server)
    trace.disable()
    return {r.rid: list(r.out) for r in server.finished}


def _parents(spans):
    """Each span's parent (an index into ``spans``, or None): the innermost
    span open at its start."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent, stack = [None] * len(spans), []
    for i in order:
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        if stack:
            assert spans[i][2] <= spans[stack[-1]][2], "spans overlap without nesting"
            parent[i] = stack[-1]
        stack.append(i)
    return parent


@pytest.mark.parametrize("name", ARCHS)
def test_off_records_nothing_and_the_tokens_do_not_change(name):
    off = _serve(name, on=False)
    assert trace.drain() == ([], [])
    on = _serve(name, on=True)
    assert on == off and len(on) == 7
    spans, counters = trace.drain()
    assert spans and counters


@pytest.mark.parametrize("name", ARCHS)
def test_spans_nest_as_the_serving_loop_calls(name):
    _serve(name, on=True)
    spans, _ = trace.drain()
    parent = _parents(spans)
    names = [s[0] for s in spans]

    def chain(i):
        out = []
        while parent[i] is not None:
            i = parent[i]
            out.append(names[i])
        return out

    mixer = "layer.attn" if name == "dsmoe16b" else "layer.mamba"
    admits = [i for i, n in enumerate(names) if n == "serve.admit"]
    assert len(admits) == 7
    for i in admits:
        assert chain(i) == ["serve.step"]
        inner = [j for j in range(len(spans)) if parent[j] == i]
        assert [names[j] for j in inner] == ["model.prefill", "serve.cache_write",
                                             "serve.first_token"]
        prefill = inner[0]
        assert spans[prefill][3] == spans[i][3][1]          # its own request's prompt
        layers = [j for j in range(len(spans)) if parent[j] == prefill]
        want = config(name)["n_layers"]
        assert [names[j] for j in layers if names[j] == mixer] == [mixer] * want
        assert [spans[j][3] for j in layers if names[j] == mixer] == list(range(want))
    for i, n in enumerate(names):
        if n == "model.decode_step":
            assert chain(i) == ["serve.step"]
        elif n == "serve.sample":
            assert chain(i) == ["serve.step"]
        elif n in ("layer.attn", "layer.mamba", "layer.ffn"):
            assert chain(i)[0] in ("model.prefill", "model.decode_step")
    if name == "dsmoe16b":
        assert "layer.ffn" in names and "layer.mamba" not in names
    else:
        assert "layer.ffn" not in names and "layer.attn" not in names


@pytest.mark.parametrize("name", ARCHS)
def test_kv_used_is_the_busy_slots_positions_at_every_step(name):
    want = []
    _serve(name, on=True, per_step=lambda srv: want.append(
        sum(int(srv.pos[s]) for s in range(srv.n_slots) if srv.active[s] is not None)))
    spans, counters = trace.drain()
    used = [v for n, _, v in counters if n == "serve.kv_used"]
    reserved = [v for n, _, v in counters if n == "serve.kv_reserved"]
    steps = [s for s in spans if s[0] == "serve.step"]
    assert used[:len(want)] == want and len(used) == len(steps)
    assert reserved == [3 * 64] * len(steps)
    assert [s[3] for s in steps][:1] == [3]


def test_disabled_span_hands_back_one_shared_context():
    a, b = trace.span("serve.step"), trace.span("k5", 4)
    assert a is b
    with a as s:
        s.arg = 1
    trace.count("serve.kv_used", 1)
    assert trace.drain() == ([], [])
