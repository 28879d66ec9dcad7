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

The model is built with the reference's sharding policy on a shape-only
(data, model) = (dp, tp) mesh (``mesh_policy``), which distributes nothing
here but gives the MoE layers the reference's dispatch groups:
``moe_groups`` = dp when dp divides the batch, each group with its own
capacity.

A vision or audio arch's prefill takes its frontend embeddings as the
reference's ``input_specs`` makes them (``prefill_inputs``); decode steps
take tokens.

A train cell counts one whole train step of the reference's
``make_train_step`` with the default ``TrainStepConfig`` (one microbatch,
clipping at 1.0): the loss (``flags.remat`` and ``flags.loss_chunks``
apply), its gradients (``torch.autograd.grad``, with the recompute that
remat adds) and the optimizer's update of every parameter, under the same
mode.  The optimizer follows ``pick_optimizer``'s rule: AdamW, or
Adafactor above 100e9 parameters; ``meta["optimizer"]`` names it.  The
train state is made before the count and is not counted as work.  Per
device, with the reference's sharding rules (``parallel.sharding`` on a
shape-only ``(data, model)`` mesh of dp × tp, ``flags.fsdp``):

* ``arg_bytes``: each leaf of the state over the devices its spec splits it
  over (parameters and AdamW's moments by the parameter rules, Adafactor's
  factored slots replicated, as the reference's rules leave them), plus the
  batch by ``batch_spec``; ``output_bytes``: the new state, as large;
* ``temp_bytes``: the peak of live intermediates (activations, gradients,
  the optimizer's temporaries) over n;
* the collectives (``train_collective_bytes``), per device, with the ring
  costs above, P_m a parameter's bytes over its model-axis share, X the
  (B·S/dp, d_model) activation's bytes and R the mixers plus FFNs:
  - FSDP (``fsdp``, dp > 1), for each parameter its spec splits over
    ``data``: two all-gathers over dp (forward, and again for the
    backward), 2·P_m·(dp−1)/dp;
  - the gradient reduction over dp: a reduce-scatter into those shards,
    P_m·(dp−1)/dp, with ``grad_rs``; an all-reduce, 2·P_m·(dp−1)/dp,
    without it and for every parameter not split over ``data``;
  - tensor parallelism (tp > 1): each of the R reductions of X in the
    forward pass, once more for the input gradients in the backward pass,
    and once more with remat (``selective`` or ``full``), whose recompute
    runs the forward again: an all-reduce 2·X·(tp−1)/tp each, or with
    ``sp`` an all-gather plus a reduce-scatter, X·(tp−1)/tp each.  A MoE
    layer's reduction is its shared experts' (none without them); its
    routed experts split over model (``ShardingPolicy.expert_block``, where
    tp divides E) instead gather their outputs over model in the same
    passes, Y·(tp−1)/tp each, Y = E·C·d_model bytes of its group's expert
    buffer (C the capacity of B·S/g tokens, g = ``moe_groups``), and with
    ``sp`` take their rows whole over model first, one more all-gather plus
    reduce-scatter of X per pass;
  - a Mamba-2 mixer whose heads the model axis splits (tp divides H;
    ``models.mamba2.mamba_block_sharded``), besides its reduction of X
    above: B and C's weights (``wb``, ``wc`` (D, N), ``conv_b``, ``conv_c``
    (N, K)), W bytes in all, gathered over model in the forward pass and
    again with remat, W·(tp−1)/tp each, and their gradients reduced in the
    backward pass (a reduce-scatter, W·(tp−1)/tp, where tp divides N; an
    all-reduce, 2·W·(tp−1)/tp, where the rules leave them whole);
    ``out_proj`` taken from its columns' split to its rows' where tp
    divides D (an all-to-all, O·(tp−1)/tp, O = d_inner·D/tp bytes) in the
    same passes as the gather and back for its gradient; the gated norm's sum of squares,
    an fp32 all-reduce of B·S/dp values in every pass.  The per-head
    vectors' gathers (``A_log``, ``D``, ``dt_bias``, the biases and norm
    scales, under d_inner values each) are not counted.  Where tp does not
    divide H every rank runs the whole mixer: no reduction of X, its
    weights that the rules split over model gathered in the forward pass
    and again with remat, P_m·(tp−1)/tp each, and with ``sp`` the input's
    sequence gathered in those passes and the output's gradient in the
    backward pass, X·(tp−1)/tp each;
  - the vocabulary split over model (where tp divides V): the embedding
    lookup's sum over the vocabulary shares, an all-reduce 2·X·(tp−1)/tp,
    or with ``sp`` a reduce-scatter and, for its gradient, an all-gather,
    X·(tp−1)/tp each; the head's input, gathered over the sequence with
    ``sp`` (an all-gather, X·(tp−1)/tp, and a reduce-scatter of its
    gradient) and otherwise whole, its gradient summed over the
    vocabulary shares (an all-reduce, 2·X·(tp−1)/tp); the cross entropy's
    max, sum of exponentials and gold logit, three fp32 all-reduces of
    B·S/dp values.  With ``loss_chunks`` > 1 the backward pass recomputes
    each chunk's logits: the head's gather under ``sp`` and the cross
    entropy's three all-reduces once more.

``meta["one_device_bytes"]`` is what the whole cell holds on one device,
unsharded: the weights (a train cell's whole state, updated in place), the
inputs, the peak of intermediates and the outputs; ``launch.dryrun``'s fit
check reads it.

``hbm_est_per_device`` is not set here: ``launch.explore.make_build_fn``
sets it from ``roofline/traffic.py``, as the reference does.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import BuildFlags, Model
from repro_torch.parallel.sharding import ShardingPolicy
from repro_torch.roofline.analysis import Artifact
from repro_torch.train.optimizer import adafactor, adamw, cosine_schedule
from repro_torch.train.train_step import TrainStepConfig, init_train_state, make_train_step


def pick_optimizer(arch: ArchConfig, name: Optional[str] = None):
    """AdamW by default; Adafactor where AdamW's state cannot fit the
    reference's pod (llama4-maverick-400b: 400e9 × 8 B of fp32 slots)."""
    if name is None:
        name = "adafactor" if arch.param_count() > 100e9 else "adamw"
    sched = cosine_schedule(3e-4, 2000, 100_000)
    return (adafactor(sched) if name == "adafactor" else adamw(sched)), name


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


def mesh_policy(dp: int, tp: int, flags: BuildFlags) -> ShardingPolicy:
    """The reference's rules on a shape-only (data, model) = (dp, tp) mesh."""
    return ShardingPolicy(MeshShape((dp, tp), ("data", "model")), fsdp=flags.fsdp, sp=flags.sp)


def train_collective_bytes(arch: ArchConfig, shape: ShapeConfig, flags: BuildFlags,
                           dp: int, tp: int, param_shares) -> Dict[str, float]:
    """Per-device wire bytes of one train step by collective kind (the
    module docstring's formulas).  ``param_shares``: per parameter, (its
    bytes, its model-axis share, split over ``data``?)."""
    out: Dict[str, float] = {}

    def add(kind, v):
        if v:
            out[kind] = out.get(kind, 0.0) + v
    if dp > 1:
        f = (dp - 1) / dp
        for nbytes, model_share, data_split in param_shares:
            pm = nbytes / model_share
            if data_split:
                add("all-gather", 2 * pm * f)
                if flags.grad_rs:
                    add("reduce-scatter", pm * f)
                else:
                    add("all-reduce", 2 * pm * f)
            else:
                add("all-reduce", 2 * pm * f)
    if tp > 1:
        f = (tp - 1) / tp
        b, itemsize = shape.global_batch, flags.tdtype.itemsize
        tokens = b * shape.seq_len / dp
        x = tokens * arch.d_model * itemsize
        specs = arch.layer_specs()
        n_moe = sum(s.ffn == "moe" for s in specs)
        n_mamba = sum(s.mixer == "mamba" for s in specs)
        whole_mamba = n_mamba if arch.n_ssm_heads % tp else 0
        n_red = sum(1 + (s.ffn == "dense") for s in specs) + (
            n_moe if arch.n_shared_experts else 0) - whole_mamba
        passes = 2 + (flags.remat != "none")
        if flags.sp:
            n_red += n_moe                  # the MoE's rows taken whole over model
            add("all-gather", passes * n_red * x * f)
            add("reduce-scatter", passes * n_red * x * f)
        else:
            add("all-reduce", passes * n_red * 2 * x * f)
        if n_moe and arch.n_experts % tp == 0:
            from repro_torch.models.moe import expert_capacity

            g = mesh_policy(dp, tp, flags).moe_groups(b)
            y = arch.n_experts * expert_capacity(b * shape.seq_len // g, arch) * arch.d_model
            add("all-gather", passes * n_moe * y * itemsize * f)
        fwd = passes - 1                      # the forward pass, and its recompute
        if whole_mamba:
            d, di, n, k = arch.d_model, arch.d_inner, arch.ssm_state, arch.ssm_conv
            split = [(d * di, di), (d * di, di), (d * n, n), (d * n, n), (di * k, di),
                     (n * k, n), (n * k, n), (di * d, d)]
            w = sum(size for size, dim in split if dim % tp == 0) * itemsize
            add("all-gather", fwd * whole_mamba * w * f)
            if flags.sp:
                add("all-gather", passes * whole_mamba * x * f)
        elif n_mamba:
            w = 2 * (arch.d_model + arch.ssm_conv) * arch.ssm_state * itemsize
            o = arch.d_inner * arch.d_model / tp * itemsize
            add("all-gather", fwd * n_mamba * w * f)
            if arch.ssm_state % tp == 0:
                add("reduce-scatter", n_mamba * w * f)
            else:
                add("all-reduce", n_mamba * 2 * w * f)
            if arch.d_model % tp == 0:
                add("all-to-all", passes * n_mamba * o * f)
            add("all-reduce", passes * n_mamba * 2 * tokens * 4 * f)
        if arch.vocab_size % tp == 0:
            head = 1 + (flags.loss_chunks > 1)   # the forward pass, and its recompute
            if flags.sp:
                add("reduce-scatter", 2 * x * f)
                add("all-gather", (1 + head) * x * f)
            else:
                add("all-reduce", 2 * 2 * x * f)
            add("all-reduce", head * 3 * 2 * tokens * 4 * f)
    return out


def train_inputs(arch: ArchConfig, b: int, s: int, dtype, device="meta"):
    """A train batch: the prefill inputs of ``s`` positions and (B, S) labels."""
    batch = prefill_inputs(arch, b, s, dtype, device)
    batch["labels"] = torch.zeros((b, s), dtype=torch.long, device=device)
    return batch


def _count_train_step(model, opt, batch) -> CostMode:
    """One train step of ``model`` on ``batch`` counted under a CostMode;
    every intermediate is freed when it returns."""
    tsc = TrainStepConfig()
    state = init_train_state(model, opt, tsc)
    step = make_train_step(model, opt, tsc)
    with CostMode() as mode:
        step(state, batch)
    return mode


def _slot_bytes(p, opt_name: str) -> int:
    """The optimizer's fp32 slots of parameter ``p``: AdamW's m and v;
    Adafactor's factored row and column moments (both of the last two dims
    at least 128) or one full moment."""
    if opt_name == "adamw":
        return 2 * 4 * p.numel()
    shape = tuple(p.shape)
    if len(shape) >= 2 and min(shape[-2:]) >= 128:
        return 4 * (p.numel() // shape[-1] + p.numel() // shape[-2])
    return 4 * p.numel()


def _build_train(arch, shape, dp, tp, flags, optimizer) -> BuiltCell:
    n_dev = dp * tp
    opt, opt_name = pick_optimizer(arch, optimizer)
    policy = mesh_policy(dp, tp, flags)
    model = Model(arch, flags, device="meta", seed=None, policy=policy)
    batch = train_inputs(arch, shape.global_batch, shape.seq_len, flags.tdtype)
    mode = _count_train_step(model, opt, batch)
    specs = policy.param_specs(model)
    state = whole = 4.0                      # the step
    param_shares = []
    for name, p in model.named_parameters():
        spec, nbytes, slots = specs[name], _nbytes(p), _slot_bytes(p, opt_name)
        split = policy.shards(spec)
        # AdamW's moments are placed as the parameter, Adafactor's replicated
        state += nbytes / split + (slots / split if opt_name == "adamw" else slots)
        whole += nbytes + slots
        used = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        param_shares.append((nbytes, tp if "model" in used else 1, "data" in used))
    in_bytes = sum(_nbytes(t) / policy.shards(policy.batch_spec(tuple(t.shape)))
                   for t in batch.values())
    coll = train_collective_bytes(arch, shape, flags, dp, tp, param_shares)
    temp = mode.peak - mode.live
    art = Artifact(
        flops_per_device=mode.flops / n_dev,
        bytes_per_device=mode.bytes / n_dev,
        wire_bytes_per_device=sum(coll.values()),
        collectives=coll,
        arg_bytes=int(state + in_bytes),
        temp_bytes=int(temp / n_dev),
        output_bytes=int(state),
        n_devices=n_dev)
    # on one device: the state, updated in place, the batch and the peak
    one = whole + sum(_nbytes(t) for t in batch.values()) + temp
    return BuiltCell("train", art, n_dev, {"arch": arch.name, "shape": shape.name,
                                           "optimizer": opt_name,
                                           "one_device_bytes": int(one)})


def build_cell(arch: ArchConfig, shape: ShapeConfig, dp: int, tp: int,
               flags: BuildFlags = BuildFlags(), optimizer: Optional[str] = None
               ) -> BuiltCell:
    """Count one train, prefill or decode step of ``arch`` at ``shape`` on
    meta (``optimizer``: a train cell's, else ``pick_optimizer``'s)."""
    if shape.kind == "train":
        return _build_train(arch, shape, dp, tp, flags, optimizer)
    n_dev = dp * tp
    model = Model(arch, flags, device="meta", seed=None, policy=mesh_policy(dp, tp, flags))
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
    # on one device: the weights, the inputs, the peak and the outputs
    one = params + in_bytes + temp + out_bytes
    return BuiltCell(shape.kind, art, n_dev, {"arch": arch.name, "shape": shape.name,
                                              "one_device_bytes": int(one)})


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
