"""Spans and counters of the serving path, on the host's clock.

A span is ``(name, start_ns, end_ns, arg)`` and a counter sample
``(name, t_ns, value)``, both on ``time.perf_counter_ns()``; they go to one
list per process.  Tracing is off unless ``enable()`` turns it on: while off,
``span`` hands back one shared no-op context (no clock read, no allocation)
and ``count`` returns at once, so the instruments stay in the code at no
measurable cost.  ``drain()`` returns what was recorded and clears it.  A
caller that must compute a counter's value asks ``enabled()`` first.

Spans nest: each is opened and closed on the thread that serves, so a
span's parent is the innermost one open at its start.  A device profiler's
launch records, put on this clock, tell which span launched each kernel.

Spans (``arg`` in brackets) and what an operator reads them for:

- ``serve.step`` (busy slots after admission): one ``SlotServer.step``; the
  host's time outside every step is the client's and the caller's.
- ``serve.admit`` ((request id, prompt length)): one admission, prefill,
  cache write and first token; how much of a step, and of the device's idle
  time, admission holds.
- ``serve.cache_write``: the copy of a prefill's caches into the slot.
- ``serve.first_token``: the argmax of the prefill's logits, where the host
  waits for the prefill to finish on the device.
- ``serve.sample``: decode's argmax, its copy to the host (the wait for the
  decode step) and the per-slot bookkeeping.
- ``model.prefill`` (prompt tokens): ``Model.prefill``; device time per
  prompt token, and the kernels each prefill launched.
- ``model.decode_step`` (batch rows): ``Model.decode_step``; the host's
  time to dispatch one decode step, and the device time it launched.
- ``model.decode_replay``: inside ``model.decode_step``, the launch of its
  captured CUDA graph; the device time of the whole step is put down to it.
- ``layer.attn`` / ``layer.mamba`` (layer index): a layer's mixer, in
  prefill and decode; which share of a step's device time is attention.
- ``layer.ffn`` (layer index): a layer's dense or MoE feed-forward.
- ``k5`` ((rows, k)): the host path of one launch of the MoE gating kernel
  K5, routing each row to k experts.
- ``k6`` (rows): the host path of one call of the decode attention kernel
  K6 (its checks, two allocations and the ctypes call of its launches).

A decode step replayed from a CUDA graph runs no Python of its layers: the
``layer.*``, ``k5`` and ``k6`` spans of a graphed step fire in the
``model.decode_step`` that captures it (twice: its eager run, then the
capture), and not on its replays.

Counters:

- ``serve.kv_used``: once a step, the positions the busy slots hold (the sum
  of their ``pos``), and ``serve.kv_reserved`` beside it, the positions the
  cache was allocated for (slots × ``max_len``); their ratio is the share of
  the K/V cache a deployment of this size puts to use.
- ``serve.state_bytes``: once a step beside them, the bytes of recurrent
  state the busy slots hold (each Mamba layer's fp32 state and conv window:
  fixed per slot, whatever its length), which ``serve.kv_used`` does not see.
- ``moe.assignments`` and ``moe.dropped``: once a model step
  (``Model.prefill``, ``Model.decode_step``), the routed (token, expert)
  assignments of its MoE layers and those dropped over an expert's
  capacity; ``moe.dropped``'s value is a 0-dim device tensor, so that
  counting makes no host sync (read it once the run is over).  A replayed
  decode step records them too: a graph captured while tracing is on sums
  its drops on the device, and each replay records a copy of that sum.

The kernels' launch counters (``kernels.*.launches``) and ``Model``'s
``decode_graph_captures`` and ``decode_graph_replays`` (the decode steps
that captured a CUDA graph and that replayed one) are separate: they are
always on, and tests read them to tell which route a call took.  The
kernels' count calls of the wrappers, so a kernel in a graphed decode step
counts once at its capture and not on its replays.
"""
from __future__ import annotations

import time

_spans: list = []
_counters: list = []
_on = False


class _Span:
    __slots__ = ("name", "arg", "start")

    def __init__(self, name, arg):
        self.name, self.arg = name, arg

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _spans.append((self.name, self.start, time.perf_counter_ns(), self.arg))
        return False


class _Off:
    """The span handed out while tracing is off; ``arg`` may be set and is dropped."""
    __slots__ = ("arg",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, arg=None):
    """A context that records the span ``name`` while tracing is on.  Its
    ``arg`` may be set before it closes, for a value known only at the end."""
    if not _on:
        return _OFF
    return _Span(name, arg)


def count(name: str, value) -> None:
    """Record a sample of the counter ``name`` while tracing is on."""
    if _on:
        _counters.append((name, time.perf_counter_ns(), value))


def drain():
    """(spans, counters) recorded so far, each in the order recorded; the records start anew."""
    global _spans, _counters
    out = _spans, _counters
    _spans, _counters = [], []
    return out
