"""Sharding policy (port of ``repro/parallel/sharding.py``): DP/FSDP over
``data`` (× ``pod``), TP over ``model``, SP on the residual stream, EP for
MoE experts, sequence-sharded KV caches.

The rules are the reference's, as plain Python over a mesh's axis names and
sizes (``launch.mesh.axes_of``: a ``DeviceMesh`` or a shape-only
``MeshShape``).  A spec is a tuple with one entry per tensor dimension (or
fewer, right-padded with ``None``): ``None``, an axis name, or a tuple of
names, as the reference's ``PartitionSpec`` holds them.  Parameter rules
read the reference's "/"-joined leaf path (``models.convert.reference_path``
gives it for a port parameter) and are right-aligned, so a port layer's
weight and the reference's stacked leaf of its layer group get the same
trailing entries.  ``_fits`` keeps the reference's choice: a dimension the
axes do not divide is replicated, not padded.

On a ``DeviceMesh`` a spec becomes DTensor placements, one per mesh
dimension: ``Shard(d)`` where tensor dimension d names that axis,
``Replicate()`` elsewhere (an entry naming two axes shards d over both,
major to minor in mesh order, as JAX tiles it).  ``param_shardings``,
``cache_shardings`` and ``batch_shardings`` distribute a tree of identical
full tensors by those placements (each rank keeps its own slice; nothing
is sent).  The reference's ``constrain_*`` become ``redistribute`` calls to
the placements of the same specs; a plain tensor passes through them
unchanged, so a model without DTensor inputs runs as before.

Row-local regions (the MoE dispatch and the Mamba-2 mixer, whose work is
per sequence) run on plain local tensors: ``local_rows`` takes this rank's
rows (its group when the rows are split over the data axes) and
``from_rows`` (or ``reduced_rows``) wraps the local result again, so the
kernels (K5, K4) see plain tensors on the rank's device.  The MoE's expert
products take the reference's expert-buffer placement (groups over data,
experts over model): ``expert_block`` gives a rank its experts' rows of its
group's buffer, ``expert_weights`` those experts' weights, and
``expert_gather`` brings the outputs of every expert back.  The Mamba-2 mixer takes its
heads' share of its weights over model where the axis divides the heads
(``head_split``, ``head_shares``), sums its gated norm's squares over
model (``model_all_reduce``) and its partial outputs into the residual's
placement (``reduced_rows``); a decode step's caches come from prefill by
``place_caches``.  The embedding lookup and the cross entropy keep the
vocabulary split over model (``vocab_lookup``, ``vocab_ce``).
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import MeshShape, axes_of

Spec = Tuple[Any, ...]
_CONTEXT_DEPTH = [0]      # nesting of ShardingPolicy.context on this process


def _right(shape, *trailing) -> Spec:
    return tuple([None] * (len(shape) - len(trailing)) + list(trailing))


class ShardingPolicy:
    def __init__(self, mesh, *, fsdp: bool = True, sp: bool = True):
        self.mesh = mesh
        names, sizes = axes_of(mesh)
        self.axis_names = names
        self.axis_sizes = dict(zip(names, sizes))
        self.tp_axis = "model" if "model" in names else None
        self.dp_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
        self.fsdp = fsdp
        self.sp = sp

    # -- helpers ---------------------------------------------------------------
    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            if a is not None:
                n *= self.axis_sizes[a]
        return n

    def _fits(self, dim: int, axes) -> Optional[Any]:
        """The axes only if they divide the dim exactly; otherwise the dim is
        replicated (llama4's 40 q-heads on a 16-way model axis, glm4's 2
        kv-heads), the surrounding dims still shard."""
        if axes is None:
            return None
        if dim % self._axis_size(axes) == 0:
            return axes
        return None

    @property
    def has_devices(self) -> bool:
        """A ``DeviceMesh`` (placements, DTensors) rather than a ``MeshShape``."""
        return not isinstance(self.mesh, MeshShape)

    @property
    def dp(self):
        return self.dp_axes if self.dp_axes else None

    @property
    def fsdp_axes(self):
        return self.dp_axes if (self.fsdp and self.dp_axes) else None

    def shards(self, spec: Spec) -> int:
        """How many ways a leaf with ``spec`` is split (its bytes per device
        are its bytes over this)."""
        return self._axis_size(tuple(a for e in spec if e is not None
                                     for a in ((e,) if isinstance(e, str) else e)))

    # -- param rules -------------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Right-aligned trailing-dim rules; leading axes (the reference's
        scanned (n_groups,) stack axis) are never sharded."""
        tp, fs = self.tp_axis, self.fsdp_axes
        f = self._fits

        def right(*trailing) -> Spec:
            return _right(shape, *trailing)

        if "embed" in path and path.endswith("table"):        # (V, D)
            return right(f(shape[-2], tp), f(shape[-1], fs))
        if path.endswith("head/w"):                            # (D, V)
            return right(f(shape[-2], fs), f(shape[-1], tp))
        if path.endswith("frontend/proj"):
            return right(f(shape[-2], fs), f(shape[-1], tp))
        if re.search(r"mixer/w[qkv]$", path):                  # (D, H, dh)
            return right(f(shape[-3], fs), f(shape[-2], tp), None)
        if path.endswith("mixer/wo"):                          # (H, dh, D)
            return right(f(shape[-3], tp), None, f(shape[-1], fs))
        if re.search(r"(mlp|shared)/wi_(gate|up)$", path):     # (D, F)
            return right(f(shape[-2], fs), f(shape[-1], tp))
        if re.search(r"(mlp|shared)/wo$", path):               # (F, D)
            return right(f(shape[-2], tp), f(shape[-1], fs))
        if re.search(r"experts/wi_(gate|up)$", path):          # (E, D, Fe)
            return right(f(shape[-3], tp), f(shape[-2], fs), None)
        if path.endswith("experts/wo"):                        # (E, Fe, D)
            return right(f(shape[-3], tp), None, f(shape[-1], fs))
        if path.endswith("router"):                            # (D, E)
            return right(f(shape[-2], fs), None)
        if re.search(r"mixer/w(z|x|b|c|dt)$", path) or path.endswith("out_proj"):
            return right(f(shape[-2], fs), f(shape[-1], tp))  # mamba (D, X)
        if re.search(r"conv_[xbc]$", path):                    # (C, K)
            return right(f(shape[-2], tp), None)
        # 1-D norms / biases / A_log etc: replicate
        return ()

    def param_specs(self, model) -> Dict[str, Spec]:
        """{port parameter name: spec} of a ``models.Model``."""
        from repro_torch.models.convert import layer_prefixes, reference_path

        prefixes = layer_prefixes(model.cfg)
        return {name: self.param_spec(reference_path(name, prefixes), tuple(p.shape))
                for name, p in model.named_parameters()}

    # -- data / cache rules --------------------------------------------------------
    def batch_spec(self, leaf_shape: Tuple[int, ...]) -> Spec:
        b = leaf_shape[0]
        return (self._fits(b, self.dp),) + (None,) * (len(leaf_shape) - 1)

    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """KV caches (…, B, S, Hkv, dh): seq-shard over model, batch over data.
        Mamba caches: batch over data, heads/channels over model.  A leading
        (n_groups,) scan axis may be present."""
        lead = len(shape) - 4
        if path.endswith("/k") or path.endswith("/v"):
            b, s, hkv, dh = shape[lead:]
            bspec = self._fits(b, self.dp)
            # batch=1 (long_500k): fold the idle data/pod axes into the
            # sequence sharding so every device holds a cache shard
            seq_axes = (self.tp_axis,) if bspec is not None else (
                tuple(self.dp_axes) + (self.tp_axis,))
            seq_axes = tuple(a for a in seq_axes if a is not None) or None
            return (None,) * lead + (bspec, self._fits(s, seq_axes), None, None)
        if path.endswith("state"):                    # (B, H, P, N)
            b, h = shape[lead], shape[lead + 1]
            return (None,) * lead + (self._fits(b, self.dp),
                                     self._fits(h, self.tp_axis), None, None)
        if path.endswith("conv"):                     # (B, K-1, C)
            lead = len(shape) - 3
            b, _, c = shape[lead:]
            return (None,) * lead + (self._fits(b, self.dp), None,
                                     self._fits(c, self.tp_axis))
        return ()

    def moe_groups(self, batch: int) -> int:
        """Group-local MoE dispatch group count (= data-parallel degree)."""
        n = self._axis_size(self.dp)
        return n if (n > 1 and batch % n == 0) else 1

    # -- specs as DTensor placements -----------------------------------------------
    def placements(self, spec: Spec):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.axis_names:
            dims = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        for e in spec:      # an entry naming several axes must list them in mesh order
            if isinstance(e, tuple):
                order = [self.axis_names.index(a) for a in e]
                if order != sorted(order):
                    raise ValueError(f"spec entry {e} is not in the mesh's axis order "
                                     f"{self.axis_names}")
        return tuple(out)

    def distribute(self, t, spec: Spec):
        """A DTensor over the mesh with ``spec``'s placements, from the full
        tensor ``t``, which every rank holds alike (each keeps its slice)."""
        from torch.distributed.tensor import distribute_tensor

        if not self.has_devices:
            raise TypeError("a shape-only mesh gives specs, not placements; build the "
                            "policy on a DeviceMesh (launch.mesh)")
        return distribute_tensor(t, self.mesh, self.placements(spec), src_data_rank=None)

    def redistribute(self, t, spec: Spec):
        """``t`` moved to ``spec``'s placements: the reference's sharding
        constraint.  A plain tensor is returned as it is."""
        from torch.distributed.tensor import DTensor

        if not isinstance(t, DTensor):
            return t
        want = self.placements(spec)
        return t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)

    def param_shardings(self, model):
        """Distribute every parameter of ``model`` by ``param_specs`` in place
        (each becomes a DTensor ``Parameter``) and attach the policy to the
        model; returns it."""
        import torch

        specs = self.param_specs(model)
        for mod_name, mod in model.named_modules():
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                full = f"{mod_name}.{pname}" if mod_name else pname
                dt = self.distribute(p.detach(), specs[full])
                mod._parameters[pname] = torch.nn.Parameter(dt, requires_grad=p.requires_grad)
        model.policy = self
        return model

    def cache_shardings(self, model, caches):
        """Distribute the per-layer caches (``Model.empty_caches``) by
        ``cache_spec`` at the reference's cache paths."""
        from repro_torch.models.convert import layer_prefixes

        prefixes = layer_prefixes(model.cfg)
        return [{k: self.distribute(t, self.cache_spec(f"{prefix}/{k}", tuple(t.shape)))
                 for k, t in cache.items()}
                for prefix, cache in zip(prefixes, caches)]

    def place_caches(self, model, caches, max_len: int):
        """Prefill's caches (DTensors) as a decode step takes them: the
        attention K/V grown to ``max_len`` positions (zero-filled, as
        ``serve.engine.pad_caches``) and every leaf moved to ``cache_spec``'s
        placements at the reference's cache paths.  Raises ``ValueError``
        where ``max_len`` is shorter than the prompt, as ``pad_caches`` does
        (padding by a negative amount would crop the K/V)."""
        import torch.nn.functional as F
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.models.convert import layer_prefixes

        def padded(t):
            if max_len < t.shape[1]:
                raise ValueError(f"a {t.shape[1]}-position prompt does not fit a "
                                 f"{max_len}-slot cache")
            whole = tuple(Replicate() if pl == Shard(1) else pl for pl in t.placements)
            local = t.redistribute(t.device_mesh, whole).to_local()
            local = F.pad(local, (0, 0, 0, 0, 0, max_len - t.shape[1]))
            return DTensor.from_local(local, t.device_mesh, whole, run_check=False)
        out = []
        for prefix, cache in zip(layer_prefixes(model.cfg), caches):
            layer = {}
            for key, t in cache.items():
                if key in ("k", "v"):
                    t = padded(t)
                layer[key] = self.redistribute(
                    t, self.cache_spec(f"{prefix}/{key}", tuple(t.shape)))
            out.append(layer)
        return out

    def batch_shardings(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: self.distribute(t, self.batch_spec(tuple(t.shape)))
                for k, t in batch.items()}

    @contextlib.contextmanager
    def context(self):
        """Plain tensors met inside the model (positions, masks, scalars) are
        taken as replicated.  The model's entry points and the train step
        enter it; a backward pass run outside them (``autograd.grad`` of a
        ``loss_fn``) must run inside it too, since its ops meet the same
        plain tensors.  Only the outermost entry opens PyTorch's
        ``implicit_replication``: it turns the switch off on its exit, which
        would end an enclosing one (a train step's around the loss)."""
        from torch.distributed.tensor.experimental import implicit_replication

        outer = _CONTEXT_DEPTH[0] == 0
        with implicit_replication() if outer else contextlib.nullcontext():
            _CONTEXT_DEPTH[0] += 1
            try:
                yield
            finally:
                _CONTEXT_DEPTH[0] -= 1

    # -- activation constraints (the reference's constrain_*) ------------------------
    def constrain_residual(self, x):
        """(B, S, D) residual stream: batch over data; seq over model if SP."""
        if x.ndim != 3:
            return x
        return self.redistribute(x, self.residual_spec(tuple(x.shape)))

    def constrain_attn_q(self, q):
        """(B, S, H, dh): seq-sharded over model with SP (K/V stay gathered);
        otherwise heads over model when divisible."""
        b, sq, h, _ = q.shape
        if self.sp and sq > 1:
            spec = (self._fits(b, self.dp), self._fits(sq, self.tp_axis), None, None)
        else:
            spec = (self._fits(b, self.dp), None, self._fits(h, self.tp_axis), None)
        return self.redistribute(q, spec)

    def constrain_attn_kv(self, k):
        """(B, S, Hkv, dh): replicated over model under SP; head-sharded when
        SP is off and the head count divides."""
        b, skv, hkv, _ = k.shape
        if self.sp and skv > 1:
            spec = (self._fits(b, self.dp), None, None, None)
        else:
            spec = (self._fits(b, self.dp), None, self._fits(hkv, self.tp_axis), None)
        return self.redistribute(k, spec)

    def constrain_logits(self, x):
        b, v = x.shape[0], x.shape[-1]
        spec = (self._fits(b, self.dp),) + (None,) * (x.ndim - 2) + (self._fits(v, self.tp_axis),)
        return self.redistribute(x, spec)

    def constrain_tokens_for_moe(self, x):
        """(B, S, D) purely batch-sharded (the dispatch groups own contiguous rows)."""
        return self.redistribute(x, (self._fits(x.shape[0], self.dp), None, None))

    # -- expert parallelism (the reference's constrain_expert_buffer) ------------------
    def _expert_placements(self, n_experts: int, split: bool):
        """(g, E, ...): groups over the data axes when the rows are split,
        experts over model where the axis divides E."""
        from torch.distributed.tensor import Replicate, Shard

        ep = self._fits(n_experts, self.tp_axis) is not None
        return tuple(Shard(0) if (split and a in self.dp_axes)
                     else Shard(1) if (ep and a == self.tp_axis) else Replicate()
                     for a in self.axis_names)

    def expert_block(self, buf, split: bool, like):
        """This group's expert buffer ``buf`` (E, C, D), equal on every
        model rank, -> this rank's block of it: (E / tp, C, D) where the
        model axis divides E.  In the backward pass the blocks' gradients
        are gathered over model, so every rank gets its rows' whole
        gradient."""
        from torch.distributed.tensor import DTensor

        mesh = like.device_mesh
        dt = DTensor.from_local(buf[None], mesh, self._rows(split), run_check=False)
        return dt.redistribute(mesh, self._expert_placements(buf.shape[0], split)).to_local()[0]

    def expert_gather(self, y, n_experts: int, split: bool, like):
        """The inverse of ``expert_block``: this rank's expert outputs
        (E / tp, C, D) -> the group's (E, C, D) on every model rank (an
        all-gather over model, the reference's combine)."""
        from torch.distributed.tensor import DTensor

        mesh, rows = like.device_mesh, self._rows(split)
        dt = DTensor.from_local(y[None], mesh, self._expert_placements(n_experts, split),
                                run_check=False)
        return dt.redistribute(mesh, rows).to_local(grad_placements=rows)[0]

    def expert_weights(self, w, split: bool):
        """This rank's experts of the stacked expert weight DTensor ``w``
        (E, ...) as a plain tensor: its share of E over model where the axis
        divides E (the parameter's own placement there), whole over the FSDP
        axes.  The gradient is summed over the data axes when the rows are
        ``split`` (each data rank saw other rows)."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        ep = self._fits(w.shape[0], self.tp_axis) is not None
        keep = [Shard(0) if (ep and a == self.tp_axis) else Replicate() for a in self.axis_names]
        grad = [Partial() if (split and a in self.dp_axes) else pl
                for a, pl in zip(self.axis_names, keep)]
        return w.redistribute(w.device_mesh, keep).to_local(grad_placements=grad)

    # -- the vocabulary over model (the reference's embedding table and logits) ---------
    def _vocab_placements(self, vocab: int, dim: int, split: bool):
        """Dimension ``dim`` (the vocabulary) over model where the axis
        divides ``vocab``, the rows (dimension 0) over the data axes when
        ``split``, replicated elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        vs = self._fits(vocab, self.tp_axis) is not None
        return tuple(Shard(dim) if (vs and a == self.tp_axis)
                     else Shard(0) if (split and a in self.dp_axes) else Replicate()
                     for a in self.axis_names)

    @staticmethod
    def share_of(t, dim: int):
        """(offset, size) of this rank's share of dimension ``dim`` of the
        DTensor ``t``.  The one caller of torch's private
        ``compute_local_shape_and_global_offset`` in the port."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                              t.placements)
        return offset[dim], shape[dim]

    def _sum_of_shares(self, part, vocab: int, split: bool, mesh):
        """This rank's result ``part`` over its rows, from its vocabulary
        share alone -> the DTensor of the shares' sum (pending over model
        where the vocabulary is split, until its first use)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        stacked = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim != 0
                        else Shard(1) if isinstance(pl, Shard) else Replicate()
                        for pl in self._vocab_placements(vocab, 1, split))
        return DTensor.from_local(part[None], mesh, stacked, run_check=False).sum(dim=0)

    def vocab_lookup(self, table, tokens):
        """The embedding rows (B, S, D) of the token-id DTensor ``tokens``
        from the table DTensor (V, D), with the vocabulary over model as the
        reference places it: each rank looks its rows' ids up in its share
        of the vocabulary, gathered over the FSDP axes only, and the shares'
        rows are summed over model.  (DTensor's own index rules fail in the
        backward pass in PyTorch 2.11.)"""
        import torch
        from torch.distributed.tensor import Partial

        split = self.row_split(tokens.shape[0])
        keep = self._vocab_placements(table.shape[0], 0, False)
        grad = [Partial() if (split and a in self.dp_axes) else pl
                for a, pl in zip(self.axis_names, keep)]
        share = table.redistribute(table.device_mesh, keep)
        off, n = self.share_of(share, 0)
        local = share.to_local(grad_placements=grad)
        ids = self.local_rows(tokens, split) - off
        inside = (ids >= 0) & (ids < n)
        rows = torch.where(inside[..., None], local[ids.clamp(0, n - 1)], 0)
        return self._sum_of_shares(rows, table.shape[0], split, table.device_mesh)

    def vocab_ce(self, logits, labels):
        """(logsumexp, gold logit) over the last dimension of the fp32
        DTensor ``logits`` (B, S, V) with the vocabulary over model, as the
        reference's cross entropy takes it: the max and the sum of the
        exponentials reduce over model (DTensor's own ``logsumexp`` gathers
        the vocabulary), and the gold logit comes from the rank whose share
        holds the label (its ``gather`` rule fails on a split vocabulary in
        PyTorch 2.11)."""
        import torch

        b, _, v = logits.shape
        split = self.row_split(b)
        mesh = logits.device_mesh
        m = self.redistribute(logits.detach().amax(dim=-1, keepdim=True),
                              (self._fits(b, self.dp), None, None))
        lz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        share = logits.redistribute(mesh, self._vocab_placements(v, 2, split))
        off, n = self.share_of(share, 2)
        lab = self.local_rows(labels, split) - off
        inside = (lab >= 0) & (lab < n)
        gold = torch.gather(share.to_local(), -1, lab.clamp(0, n - 1)[..., None])[..., 0]
        return lz, self._sum_of_shares(torch.where(inside, gold, 0), v, split, mesh)

    # -- row-local regions ---------------------------------------------------------------
    def _rows(self, split: bool):
        from torch.distributed.tensor import Replicate, Shard

        return tuple(Shard(0) if (split and a in self.dp_axes) else Replicate()
                     for a in self.axis_names)

    def local_rows(self, x, split: bool, partial: bool = False):
        """This rank's rows of the DTensor ``x`` as a plain tensor: its share
        of the batch split over the data axes (``split``), else all rows,
        whole over model.  With ``partial`` each model rank's gradient is its
        own part of the whole (the rank used the rows for its heads only),
        and the parts are summed over model."""
        from torch.distributed.tensor import Partial

        rows = self._rows(split)
        grad = ([Partial() if a == self.tp_axis else pl for a, pl in zip(self.axis_names, rows)]
                if partial else None)
        return x.redistribute(x.device_mesh, rows).to_local(grad_placements=grad)

    def from_rows(self, t, split: bool, like, dim: Optional[int] = None,
                  spec: Optional[Spec] = None):
        """A local result ``t`` over this rank's rows (``local_rows``), and over
        model its share of dimension ``dim`` (whole when ``dim`` is None), as
        a DTensor on ``like``'s mesh: in ``spec``'s placements where one is
        given, else as it lies."""
        from torch.distributed.tensor import DTensor, Shard

        mesh = like.device_mesh
        placed = tuple(Shard(dim) if (dim is not None and a == self.tp_axis) else pl
                       for a, pl in zip(self.axis_names, self._rows(split)))
        dt = DTensor.from_local(t, mesh, placed, run_check=False)
        return dt if spec is None else dt.redistribute(mesh, self.placements(spec))

    # -- the Mamba-2 mixer on each rank's heads --------------------------------------------
    def head_split(self, n_heads: int) -> int:
        """How many ways the Mamba-2 mixer's heads split over model: the
        model axis's size where it divides ``n_heads``, else 1 (every model
        rank runs all heads)."""
        tp = self._axis_size(self.tp_axis)
        return tp if (tp > 1 and n_heads % tp == 0) else 1

    def head_shares(self, module, dims: Dict[str, int], split: bool, heads: int):
        """A namespace shaped like ``module`` holding, for each parameter, the
        plain tensor this rank computes with: its share over model of the
        dimension ``dims`` names for it (by its dotted name) when ``heads``
        > 1, whole elsewhere; whole over the data axes (FSDP's gather).
        Gradients: summed over the data axes when the rows are ``split``;
        over model, a share's gradient is the rank's own, and a whole
        weight's is summed over the ranks when they split the heads (each
        used it for its own heads) and taken as it is when they do not (each
        computed the same)."""
        import types

        from torch.distributed.tensor import Partial, Replicate, Shard

        def share(w, dim):
            keep = [Shard(dim) if (dim is not None and a == self.tp_axis) else Replicate()
                    for a in self.axis_names]
            grad = [Partial() if ((split and a in self.dp_axes)
                                  or (heads > 1 and dim is None and a == self.tp_axis))
                    else pl for a, pl in zip(self.axis_names, keep)]
            return w.redistribute(w.device_mesh, keep).to_local(grad_placements=grad)

        def walk(mod, prefix):
            ns = types.SimpleNamespace()
            for name, p in mod._parameters.items():
                setattr(ns, name, share(p, dims.get(prefix + name) if heads > 1 else None))
            for name, m in mod._modules.items():
                setattr(ns, name, walk(m, f"{prefix}{name}."))
            return ns
        return walk(module, "")

    def model_all_reduce(self, t, like):
        """The sum over model of each rank's plain tensor ``t`` (every rank
        gets it); its gradient is summed over model in turn."""
        return _ModelSum.apply(t, like.device_mesh.get_group(self.tp_axis))

    def model_gather(self, t, dim: int, split: bool, like):
        """Every model rank's share of dimension ``dim`` of the plain tensor
        ``t`` (over this rank's rows), concatenated in rank order, on every
        model rank."""
        from torch.distributed.tensor import DTensor, Shard

        rows = self._rows(split)
        shard = tuple(Shard(dim) if a == self.tp_axis else pl
                      for a, pl in zip(self.axis_names, rows))
        return DTensor.from_local(t, like.device_mesh, shard, run_check=False) \
            .redistribute(like.device_mesh, rows).to_local()

    def model_rank(self, like) -> int:
        return like.device_mesh.get_local_rank(self.tp_axis)

    def reduced_rows(self, part, split: bool, heads: int, like, spec: Spec):
        """This rank's result ``part`` over its rows as the DTensor with
        ``spec``'s placements: the sum of the model ranks' parts when they
        split the heads (an all-reduce, or a reduce-scatter where ``spec``
        splits a dimension over model), else the rank's own result."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if heads == 1:
            return self.from_rows(part, split, like, None, spec)
        mesh = like.device_mesh
        stacked = tuple(Shard(0) if a == self.tp_axis
                        else Shard(1) if (split and a in self.dp_axes) else Replicate()
                        for a in self.axis_names)
        dt = DTensor.from_local(part[None], mesh, stacked, run_check=False).sum(dim=0)
        return dt.redistribute(mesh, self.placements(spec))

    def residual_spec(self, shape) -> Spec:
        """The residual stream's spec (``constrain_residual``)."""
        b, s, _ = shape
        return (self._fits(b, self.dp),
                self._fits(s, self.tp_axis) if (self.sp and s > 1) else None, None)

    def row_split(self, batch: int) -> bool:
        """Whether row-local work splits ``batch`` rows over the data axes
        (as the MoE's dispatch groups do)."""
        return self.moe_groups(batch) > 1


class _ModelSum(torch.autograd.Function):
    """All-reduce (sum) over a process group whose backward pass is the
    all-reduce of the gradients: each rank's gradient of the sum is its own
    part, and every rank's input needs the whole."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def is_distributed(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@contextlib.contextmanager
def maybe_context(policy):
    """``policy.context()`` when there is a policy, else nothing."""
    if policy is None:
        yield
    else:
        with policy.context():
            yield
