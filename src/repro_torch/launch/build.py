"""Cell builder: (arch × shape × flags × dp·tp) → an ``Artifact``.

Port of ``repro/launch/build.py``, the workload adapter's counterpart.  The
reference lowers and compiles the model on ``ShapeDtypeStruct``s and reads
XLA's cost and memory analyses.  The port has no compiler to ask, so it
builds the port's ``Model`` on the ``meta`` device (no memory is
allocated, nothing runs on a device) and runs ``prefill`` or
``decode_step`` once under a ``TorchDispatchMode`` that counts, per aten op
the pass dispatches:

* FLOPs, by the counting rules of ``torch.utils.flop_counter`` (its
  ``flop_registry``: matrix products, convolutions, attention).  The mode
  does not use ``FlopCounterMode`` itself, whose module tracker installs
  forward hooks that are global to the process: two clients building in
  two threads at once would see each other's modules.  A dispatch mode is
  per thread;
* bytes accessed: the operand and result bytes of every op that is not a
  view, the unfused count (as XLA's "bytes accessed" is);
* the peak of live intermediates: the bytes of every storage an op
  created, from its creation until the last tensor on it is freed.

The counts are those of the whole model (every layer), under the
reference's default serving flags: ``attn_impl="xla"`` and
``ssd_impl="jnp"``, the plain paths, which are what the reference's explore
lowers.  The reference's own explore Artifacts count one scanned layer
group and XLA's CPU costs, which no PyTorch counter reproduces (ROADMAP
Queue 3, items 2 and 5); everything downstream of an Artifact (JMeasure,
the CSV, the searchers) matches the reference bit for bit.

Per device, with n = dp·tp devices:

* ``flops_per_device`` and ``bytes_per_device`` are the counts over n;
* ``arg_bytes`` is the parameters over tp (over dp·tp with ``fsdp``) plus
  the inputs (tokens, and a decode's caches) over n; ``output_bytes`` and
  ``temp_bytes`` (the peak of live intermediates beyond the storages the
  outputs hold when the pass ends) are over n;
* the collectives are a tensor-parallel formula, the ring costs of
  ``roofline/analysis.py``'s docstring with g = tp.  Each mixer and each
  FFN ends in a row-parallel product whose (tokens/dp, d_model) output is
  reduced over tp: an all-reduce of 2·X·(g−1)/g bytes, X the output's
  bytes, or with ``sp`` (sequence parallelism) an all-gather of the input
  plus a reduce-scatter of the output, X·(g−1)/g each.  The vocab-sharded
  head ends in an all-gather of the (batch/dp, vocab) logits,
  Y·(g−1)/g.  At tp = 1 there are none.

A vision or audio arch's prefill takes its frontend embeddings as the
reference's ``input_specs`` makes them (``prefill_inputs``); decode steps
take tokens.

``hbm_est_per_device`` is not set here: ``launch.explore.make_build_fn``
sets it from ``roofline/traffic.py``, as the reference does.  Train shapes
come with ROADMAP slice 7b.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import BuildFlags, Model
from repro_torch.roofline.analysis import Artifact

SLICE_7 = ("train shapes are not ported yet (ROADMAP slice 7b: sharding, "
           "the train cells, the dry run)")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and the peak of live intermediates of
    the ops dispatched inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}     # storage id -> [bytes, tensors]

    def _free(self, key):
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        ins = {id(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if id(t) not in ins:       # an in-place op returns its input
                self._track(t)
        return out


@dataclasses.dataclass
class BuiltCell:
    kind: str
    artifact: Artifact
    n_devices: int
    meta: Dict[str, Any]


def collective_bytes(arch: ArchConfig, shape: ShapeConfig, flags: BuildFlags,
                     dp: int, tp: int) -> Dict[str, float]:
    """Per-device wire bytes by collective kind (the formula above)."""
    if tp <= 1:
        return {}
    g = tp
    elt = flags.tdtype.itemsize
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    x = tokens / dp * arch.d_model * elt
    n_red = sum(1 + (s.ffn != "none") for s in arch.layer_specs())
    head = shape.global_batch / dp * arch.vocab_size * elt * (g - 1) / g
    if flags.sp:
        return {"all-gather": n_red * x * (g - 1) / g + head,
                "reduce-scatter": n_red * x * (g - 1) / g}
    return {"all-reduce": n_red * 2 * x * (g - 1) / g, "all-gather": head}


def _count(fn, *inputs) -> Tuple[CostMode, Any, int]:
    """(the mode's counts, fn's output, the peak of live intermediates
    beyond the storages the output holds)."""
    with torch.no_grad(), CostMode() as mode:
        out = fn(*inputs)
    return mode, out, mode.peak - mode.live


def prefill_inputs(arch: ArchConfig, b: int, s: int, dtype, device="meta"):
    """A prefill batch of ``s`` positions, as the reference's
    ``Model.input_specs``: a vision arch's F image embeddings (in the model
    dtype) ahead of s − F text tokens, an audio arch's s frame embeddings,
    else s tokens."""
    tokens = lambda n: torch.zeros((b, n), dtype=torch.long, device=device)
    embeds = lambda n: torch.zeros((b, n, arch.d_model), dtype=dtype, device=device)
    if arch.frontend == "vision":
        f = arch.n_frontend_tokens
        if s < f:
            raise ValueError(
                f"{arch.name}: a {s}-position prompt is shorter than its {f} image "
                f"tokens; give a prompt of at least {f} positions (the reference fails "
                "here too, asking for a negative number of text tokens)")
        return {"image_embeds": embeds(f), "tokens": tokens(s - f)}
    if arch.frontend == "audio":
        return {"frame_embeds": embeds(s)}
    return {"tokens": tokens(s)}


def build_cell(arch: ArchConfig, shape: ShapeConfig, dp: int, tp: int,
               flags: BuildFlags = BuildFlags()) -> BuiltCell:
    """Count one prefill or decode step of ``arch`` at ``shape`` on meta."""
    if shape.kind == "train":
        raise NotImplementedError(SLICE_7)
    n_dev = dp * tp
    model = Model(arch, flags, device="meta", seed=None)
    b = shape.global_batch
    if shape.kind == "prefill":
        inputs = (prefill_inputs(arch, b, shape.seq_len, flags.tdtype),)
        mode, out, temp = _count(model.prefill, *inputs)
    elif shape.kind == "decode":
        caches = model.empty_caches(b, shape.seq_len)
        tokens = torch.zeros((b, 1), dtype=torch.long, device="meta")
        inputs = (tokens, caches)
        # the last position of the cache: the reference lowers pos as a
        # traced scalar, and the port's decode attends over the whole cache
        mode, out, temp = _count(model.decode_step, tokens, caches,
                                  shape.seq_len - 1)
    else:
        raise ValueError(shape.kind)
    params = sum(_nbytes(p) for p in model.parameters())
    in_bytes = sum(_nbytes(t) for t in _tensors(inputs))
    out_bytes = sum(_nbytes(t) for t in _tensors(out))
    coll = collective_bytes(arch, shape, flags, dp, tp)
    art = Artifact(
        flops_per_device=mode.flops / n_dev,
        bytes_per_device=mode.bytes / n_dev,
        wire_bytes_per_device=sum(coll.values()),
        collectives=coll,
        arg_bytes=int(params / (tp * (dp if flags.fsdp else 1)) + in_bytes / n_dev),
        temp_bytes=int(temp / n_dev),
        output_bytes=int(out_bytes / n_dev),
        n_devices=n_dev)
    return BuiltCell(shape.kind, art, n_dev, {"arch": arch.name, "shape": shape.name})


# ---------------------------------------------------------------------------
# Generation workload (the paper's Llama2/LLaVA experiments): prefill of a
# prompt + N greedy decode steps against a max_len cache.
# ---------------------------------------------------------------------------


def build_generation(arch: ArchConfig, dp: int, tp: int,
                     flags: BuildFlags = BuildFlags(), batch: int = 1,
                     prompt_len: int = 64, max_len: int = 256,
                     ) -> Tuple[BuiltCell, BuiltCell]:
    pre = ShapeConfig("gen_prefill", "prefill", prompt_len, batch)
    dec = ShapeConfig("gen_decode", "decode", max_len, batch)
    return (build_cell(arch, pre, dp, tp, flags),
            build_cell(arch, dec, dp, tp, flags))
