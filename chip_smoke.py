#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails loudly (the script exits non-zero on any
failed check and then prints no result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel of every path (K3; K1a, K1b and K2 in one source;
   K4; K5; K6) compiled from ``csrc/`` with nvcc for sm_90a, one nvcc per source
   started together, with the ``-Xptxas -v`` resource report; each K3
   instantiation's tensor-core (``HGMMA``, ``HMMA``) and TMA (``UTMALDG``)
   instructions counted in its SASS (``cuobjdump -sass``): every bf16 one
   must have HGMMA and UTMALDG, every fp32 one HMMA (three TF32 passes);
   gp_sass: the float64 tensor-core (``DMMA``)
   instructions of each gp_ops kernel, which both fold products (K1a's and
   K1b's ``gp_fold_kernel``) and K2's partial pass must have, K2's two
   kernels' registers and spills (``-Xptxas -v``; none may spill), and the
   float64 instructions of one ``exp()`` in a probe built beside the
   kernels (``PROBE_SOURCE``), which K2's bound charges per pair;
   ssd_sass: the tensor-core (``HMMA``) instructions of each K4
   instantiation, which every chunk kernel, bf16 and fp32, must have, with
   its registers and spills;
3. kernel parity: K3 against its plain PyTorch version on the card
   (TF32 off), fp32 at 2e-5 and bf16 at 2e-2 (``tests/test_kernels.py``'s
   tolerances), and each bf16 case also against the plain version in fp32
   on the same inputs at one bf16 rounding (``BF16_VS_FP32``), at every
   shape the llama2-7b and deepseek-moe-16b paths give it
   (``main_path_cases``) and beyond (``EXTRA_CASES``: long prompts, GQA,
   windows, ragged edges, every head dim, gemma3-27b's heads and 1024-token
   window at a 4096-token prompt, and the fp32 calls of serve_fp32, of
   ``launch.serve``'s defaults and of train_sharded's prefill), each fp32
   case also against its mirror (``flash_attention_mirror_fp32``), every
   case launched twice and bitwise equal;
   K4 (``ssd_parity``) the same way, with y and the fp32 final state at
   ``SSD_TOL`` in fp32, on ``tests/test_kernels.py``'s grid, every shape of
   the Mamba path, a jamba-like head, H = 5 and chunks of 8 and 75, with
   every SM's shared memory filled with NaN before each launch, the fp32
   cases (mamba2-780m's widths at (4, 64) and (4, 512), odd heads and
   chunks) also against the mirror; K5 (``topk_parity``) with ids equal
   and probabilities within ``TOPK_P_TOL``, ties and ragged T included;
   K4 and K5 launched twice on the same inputs must repeat bitwise;
4. main path (serving): llama2-7b at full width in bf16 with random weights
   from a seeded ``torch.Generator``, served through ``Engine.generate`` and
   a ``SlotServer``, with ``attn_impl="flash"``; K3's launch count is reset
   just before and read just after, and must equal the number of
   attention layers times prefill calls.  The outputs are checked: the bf16
   flash path against an fp32 copy of the weights on the plain grouped path
   (at most ``DRIFT_RATIO`` times as far off as the bf16 plain path),
   flash against the plain path on a 2-layer full-width model (within 5 %
   of the logit scale), and on a small fp32 model flash against plain at
   5e-5 and SlotServer against Engine token for token;
5. main_ssm: mamba2-780m at full width and depth (48 layers) in bf16 with
   ``ssd_impl="cuda"``, the same Engine traffic and a SlotServer whose
   prompts (``SSM_SLOT_PROMPTS``) include one of 600 tokens (3 chunks); K4's
   launches must equal 48 times the prefill calls; the drift gate against an
   fp32 copy on the plain chunked path at (4, 64) and (1, 600);
6. main_moe: deepseek-moe-16b at full width and depth (28 layers) in bf16
   with flash attention and llama2-7b's traffic; K5's launches must equal 27
   MoE layers times forward calls and K3's 28 times prefill calls; the same
   traffic is served again, untimed, with the router logits K5 receives
   recorded, and they are replayed through its plain version; the drift
   gate (root-mean-square) on a 4-layer full-width copy;
7. gp_parity: K1a, K1b and K2 against their plain versions in float64 on
   real GP states (cap 64, 1024 and 8192; n = 0, on a 16-row edge, one
   before, on and one past the fold's 128-row tile edge, and 6250; B = 1,
   8 and 16 on both sides of the tell/fold switch, 32, 64, 128 and 512,
   cap below one tile; isotropic and ARD; P = 512 with staircases of S = 2
   and S = 129; K2 also at n = 0, 1 and one below, on and one past a
   64-row step edge, P = 1, 511 and 513): w, g and the new rows of L and
   L⁻¹ (``gp_append``
   against the torch tier's dense append) within 1e-10 · max(1, max|ref|),
   EHVI within 1e-8; each kernel launched twice on the same inputs must
   give bitwise-equal outputs, and K1b must read only the rows < n of w;
   each case reports the form, tiles and grids the wrapper picked
   (``gp_ops.tiles``);
8. search_small: BayesOpt (ehvi, parego) and PAL with ``gp_mode="cuda"``
   make the same picks as ``gp_mode="incremental"`` (numpy, on the host) on
   ``tpu_pod_space(n_chips=256)`` fed 1,000 observations and 30 ask/tell
   cycles;
9. search_main (the GP path): BayesOpt(ehvi, pool 512, inducing threshold
   5000) fed synthetic observations in 512-row blocks to 10⁴ and 10⁵, the
   size of the reference's ``bign_ask_curve``, for ``gp_mode="cuda"`` and
   then ``"torch"`` on the identical feed; the GP kernels' launch counts are
   reset just before the cuda run and read just after, and must equal the
   GP's ``cuda_appends``/``cuda_scores`` (K1a's and K1b's also split by
   form, fold and tell, each non-zero); every timed ask's EHVI scores,
   and the posterior means of each checkpoint's last timed pool, agree
   between the tiers within 1e-8; tell+ask ms, active set, capacity,
   device memory and where a cycle's time goes are printed;
10. times: CUDA-event times of each kernel, its plain version and the
   library call that computes the same function (where one does: K1b's
   ``torch.matmul(w.T, lib)``; beside K1a, as context, ``torch.matmul(lib,
   k12)`` on a precomputed K12; for K3
   ``scaled_dot_product_attention``, causal, or with ``enable_gqa`` and a
   boolean window mask where there is a window), as a loop
   of launches, as one launch between synchronisations and as the
   profiler's device time, beside the least time the card could take (bytes
   over 3.35 TB/s or operations over the dtype's peak, whichever is larger),
   and the serving times of all three paths; K2's line gives its grid
   (candidate tiles × row splits) and the profiler's time per kernel by
   name; ``topk_host_path`` times K5's call path piece by piece beside an
   empty kernel launched through ctypes (the launch floor); K4 at each of
   its five serving-path shapes, with its grid, the device time inside a
   CUDA graph (``graph_ms``) and its host enqueue time per call;
   ``phase_fp32_times``: K3 in fp32 at ``FP32_K3_TIMED`` (SDPA in fp32 held
   first to K3's plain version at 2e-5) and K4 in fp32 at
   ``FP32_K4_TIMED``, their bounds at three TF32 passes (``float32_tc``,
   495 / 3 TFLOP/s) and, beside, at the CUDA cores' 67 TFLOP/s;
   ``phase_decode_times``: K6 (decode attention on the cache) at
   deepseek-moe-16b's chat and longdoc decode shapes (``DECODE_TIMED``),
   beside its bound (the bytes of the positions attended and the new rows),
   the plain version and SDPA over the same cache; before that, at those
   shapes and at the main paths' own (``phase_decode_checks``: llama2-7b's
   and deepseek-moe-16b's heads, Engine's int position and SlotServer's
   per-slot ones, bf16 and fp32), the caches it writes must equal the plain
   version's bitwise and its output lie within one rounding of fp64
   attention; on the main paths (4 and 6) K6's launches must equal the
   attention layers times the decode calls.

11. explore_main (the paper's DSE loop, ``launch.explore``): llama2-7b's
   generation workload at full width, ``--algorithm bayesopt --gp cuda``,
   200 samples, 2 clients (each build counts the model on the ``meta``
   device on the host; the GP runs on the card), twice: the command as
   given (ParEGO, BayesOpt's default acquisition: K1a/K1b only) and its
   EHVI variant (the searcher built with ``strategy="ehvi"``, so K2 runs
   too; the CLI has no flag for it, as the reference's has none).  The GP
   kernels' counts are set to 0 just before each sweep and read just after,
   and must equal the GP's ``cuda_appends``/``cuda_scores``, K1a/K1b
   non-zero in both and K2 in the EHVI variant; wall seconds, evals/s,
   builds, the shares of wall time in building, in the searcher and in
   dispatch, tell+ask ms per cycle, the Pareto front's size and
   hypervolume are printed.  Then, at one client and on one
   ``--cache-dir`` (the later sweeps reuse the first one's builds), ``--gp
   cuda`` and ``--gp incremental`` for EHVI and for ParEGO must give
   identical knob and metric columns per config_id; and mamba2-780m (the
   ``ssd_chunk`` knob, d = 6) and deepseek-moe-16b (K5 on meta,
   ``--batch-size 12``: a 12-row tell padded to a fold) at full width, 32
   samples each, EHVI.  In those one-client and side sweeps every K1a, K1b
   and K2 call keeps its inputs and output (``recording``), and each is
   held, after the sweep, against its plain version (1e-10 relative, 1e-8
   absolute for K2) and against a relaunch on the same inputs (bitwise):
   the kernels at the shapes this path gives them (d = 7 and 6, capacity
   64 and 256, tells at B = 1, the 12 -> 16 fold, the live pool and
   front).  Every sweep's records must be ok, with finite time and energy
   and power inside the modeled envelope.
12. explore_durable (durable sweeps): first ``capacity_probe``, a cuda-tier
   BayesOpt snapshotted at 31 rows on a 64-row capacity and restored with
   and without the snapshot's capacity, each against the live searcher
   bitwise (only the first must agree).  Then the paper's command as given,
   ``--gp cuda --clients 1 --samples 200 --checkpoint-dir D`` on
   explore_main's build cache, run as ``python -m
   repro_torch.launch.explore`` in a subprocess with ``--chaos-crash-at``
   70 (past two snapshots at ``--checkpoint-every 25``) and 10 (before any:
   the whole log replays); each must exit with 42.  Each is resumed with
   ``--resume`` in a fresh process (this script's ``--resume-child``
   mode), which must exit with 0, counts its K1a/K1b/K2 launches (equal to
   the GP's counters, K1a/K1b above zero) and holds each recorded call
   against its plain version; it reports the replay (events, late tells,
   ask mismatches, from a snapshot or not).  The CSV must have 200 rows,
   ids 0-199 once each, every row bit-identical (``float.hex`` of every
   metric) to explore_parity's uninterrupted ParEGO ``--gp cuda`` sweep.
13. serve_explore_main (the multi-tenant service): ``launch.serve_explore
   --workload llama2-7b --clients 2 --fleet-cache serve --tenants T.json
   --checkpoint-root R`` on a fresh cache directory, three tenants
   (``SERVE_TENANTS``: BayesOpt ``--gp cuda`` 100 samples at weight 2, PAL
   ``--gp cuda`` 50, random 50).  Each tenant's ids are 0..n-1 once each;
   every row's metrics equal the same knobs' in explore_main's CSVs where
   they appear there, and a re-evaluation on explore_main's builds for
   every row; the fleet builds each sw fingerprint exactly once; the GP
   tenants launch K1a/K1b (launches equal to the tenants' GP counters) and
   every recorded call is held against its plain version.  Then the same
   tenants at one client with ``--gp cuda`` and ``--gp incremental`` must
   give every tenant the same rows.
   Both phases print their wall seconds and the nvidia-smi line.
14. frontends_main (after main_moe): llava-v1.5-7b, internvl2-2b and
   musicgen-medium at full width and depth in bf16 with flash attention:
   batch 4, 576 image embeddings + 64 text tokens (vision, through
   ``Engine.generate``) or 640 frame embeddings (audio: the prefill and
   ``decode_step``s, since the Engine refuses a batch without tokens), 32
   new tokens; K3's launches (set to 0 just before, read just after) must
   equal the layers; K3 at these three prefill shapes (d = 64 for
   musicgen) is in phase 3's parity cases; the drift gate against an fp32
   twin on the plain path at full depth; prefill ms, decode ms per token,
   peak memory.
15. explore_llava (after serve_explore_main): the paper's LLaVA sweep,
   ``launch.explore --workload llava-v1.5-7b --prompt-len 640 --gp cuda``,
   32 samples, 2 clients; then one client, ``--gp cuda`` (calls recorded
   and held against the plain versions) against ``--gp incremental``:
   identical columns.
16. train_main: (a) ``python -m repro_torch.launch.train`` (tinyllama-1.1b,
   full size, fp32, batch 8 x 128, 20 steps, a checkpoint every 5) crashed
   by ``--fault-at 12`` (exit 42) and resumed in a fresh process (``resumed
   from step 10``), its losses bitwise equal to an uninterrupted run's;
   (b) deepseek-moe-16b at full width cut to 4 layers, fp32, remat
   selective, batch 4 x 512: step 1's loss and the routers' gradients with
   K5 against K5's plain version (``TRAIN_LOSS_RTOL``,
   ``ROUTER_GRAD_RTOL``; K5 at T = 2048 is in phase 3's cases), then 10
   steps whose K5 launches must equal 3 MoE layers x (forward + recompute)
   x 10, the loss falling; step ms, tokens/s and peak memory.

17. explore_train (slice 7b): the paper's sweep on a train shape,
   ``launch.explore --workload llama2-7b --shape train_4k --algorithm
   bayesopt --gp cuda --clients 2``, 14 samples (BayesOpt's 12 random picks
   and two more), as given (ParEGO) and as its EHVI variant on the first
   sweep's build cache; each build counts one whole train step of
   llama2-7b at full width on ``meta`` (forward, backward, AdamW); every
   record ok; K1a and K1b launched in both sweeps and K2 in the EHVI one
   (counts set to 0 just before, read just after, equal to the GP's
   counters), every recorded call held against its plain version; s per
   build, the build share of wall, evals/s.
18. train_sharded (slice 7b): an NCCL process group of one rank on the card
   and ``ShardingPolicy(make_mesh_dp_tp(1, 1))``: deepseek-moe-16b as
   train_main (b) runs it (full width, 4 layers, fp32, remat selective,
   batch 4 × 512), 5 AdamW steps without and 5 with the policy (DTensor
   parameters, optimizer slots and batches) from the same seed, the
   largest relative loss gap at most 2e-4; K5's launches on the sharded
   path (set to 0 just before, read just after) equal MoE layers ×
   (forward + recompute) × steps; K5 against its plain version on the
   sharded model (loss, router gradients); ``psum_int8`` over the one-rank
   group bitwise equal to the local quantise and dequantise; a DTensor
   train state (reduced deepseek-moe-16b, for time) through a checkpoint
   and back into its placements, bitwise; a prefill of llama2-7b (full
   width, 2 layers, fp32, batch 4 × 512) with ``attn_impl="flash"`` under
   ``ShardingPolicy(mesh, sp=False)``: K3 launched on each rank's block
   (count set to 0 just before, read just after, one per layer), the
   logits held against the same model's unsharded flash prefill; then the
   same prefill under ``sp=True``, q's sequence gathered for K3 (again one
   launch per layer, the logits within 1e-5 of max |logit|).
19. sharded_ssm (slice 8): mamba2-780m at full width and depth (48
   layers), fp32, ``ssd_impl="cuda"``, on an NCCL group of one rank under
   ``ShardingPolicy(make_mesh_dp_tp(1, 1), sp=True)`` (the mixer on the
   rank's rows and heads, its decode step against the caches in
   ``cache_spec``'s placements): a prefill of 4 × 512 and 8 greedy
   ``decode_step``s, without and with the policy from the same weights;
   K4's launches on the sharded prefill (set to 0 just before, read just
   after) equal 48; the first layer's K4 call on the sharded prefill held
   against K4's plain version; the logits within 1e-5 of max |logit| of
   the unsharded run at every step, the greedy tokens equal; prefill ms,
   decode ms per step, peak memory.
20. examples (slice 8): the four ``examples/torch_*.py`` run in this
   process on the card: serve_batched (K5's launches on deepseek-moe-16b
   counted: its MoE layers × forward calls), train_100m at its default
   ~100M size to 60 steps and then resumed to 70 ("resumed from step 60",
   the loss falling), quickstart's 40 configs all ok, and
   multi_board_zmq where pyzmq imports (otherwise one line says that it
   is missing); wall seconds of each.

21. serve_fp32 (after main_moe): ``repro_torch.launch.serve.main`` at its
   defaults (fp32, flash, cuda, batch 4) but ``--arch``, ``--prompt-len 64``
   and ``--gen 8``: llama2-7b at full width and depth (32 layers, about 27
   GB), then mamba2-780m (48 layers); K3's and K4's launches per prefill
   (32 and 48), the first K3 and K4 call held against their plain
   versions, the prefill logits against the same weights on the plain
   paths within 1e-5 of max |logit| or, with attention, no farther from
   them than the same weights with K3's plain version in float64 in its
   place (the fp32 rounding floor: about 1.2e-5 at 32 fp32 layers),
   prefill ms, decode ms per token and peak memory.

Standard output ends with a ``kernels`` JSON line (K3's and K4's bf16 and
fp32 paths, K5's and the GP kernels' entries also carry
``launches_by_path``), the nvidia-smi line and
``{"ok": true, "device": {...}}``.  ``--only a,b`` builds the kernels and
runs only the named phases, printing no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
# dense peaks from NVIDIA's H100 SXM data sheet: fp32 off the tensor cores,
# fp64 on them (DMMA; 34 TFLOP/s on the CUDA cores)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 67e12,
              # fp32 on the tensor cores at fp32 accuracy: three TF32 products
              # (hi·hi + hi·lo + lo·hi) per fp32 product, 495 / 3 TFLOP/s: the
              # least time the card could take for an fp32-accurate product,
              # the bound of K3's and K4's fp32 paths (K5 and the GP keep theirs)
              "float32_tc": 495e12 / 3}
F64_CUDA_CORE_FLOPS = 34e12    # float64 off the tensor cores: a DFMA issue is 2 flop
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# A bf16 kernel output against the plain version run in fp32 on the same
# (bf16-valued) inputs: one bf16 rounding of the output (at most 2**-8 of
# its magnitude) plus fp32 summation noise.
BF16_VS_FP32 = {"atol": 1e-4, "rtol": 2 ** -8}
N_LAYERS = 32                                    # llama2-7b's full depth
SEED = 0
ARCH = "llama2-7b"
# The main path's traffic: one Engine batch, and the SlotServer's requests
# (each prefilled alone, so K3 sees B=1 at each prompt length).
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_NEW = 4, 64, 32
SLOT_PROMPTS = (64, 17, 40, 33)
SLOT_NEW = (8, 12, 6, 10)
# bf16 flash prefill logits over 32 layers may sit at most this many times
# as far from the fp32 reference as the bf16 plain grouped path does.
DRIFT_RATIO = 1.25
# The Mamba-2 path (K4) and the MoE path (K5, K3) at full width and depth.
SSM_ARCH, MOE_ARCH = "mamba2-780m", "deepseek-moe-16b"
# The Mamba SlotServer's prompts: the 600-token one carries the state across
# three 256-row chunks of K4 (the last one ragged); 64 fills one chunk.
SSM_SLOT_PROMPTS = (64, 17, 600, 33)
MOE_DRIFT_LAYERS = 4          # the dense layer and 3 MoE layers at full width
SSD_TOL = 1e-4                # tests/test_kernels.py's ssd tolerance (fp32; the state)
TOPK_P_TOL = 1e-6             # tests/test_kernels.py's top-k tolerance


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def single_ms(fn, reps=10):
    """Median CUDA-event time of one call of ``fn`` between synchronisations:
    no queue of launches behind it, so host work between launches cannot
    hide in it or add to it."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attended_pairs(s, window):
    """(query, key) pairs a causal (windowed) attention over s positions needs."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(window, i + 1) for i in range(s))


def flash_bound(b, s, h, hkv, d, window, dtype, peak=None):
    """(bound_ms, bound_by) of one attention call: q, k, v read once, o written
    once; operations at ``peak`` FLOP/s (by default the dtype's product rate)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * b * s * d * (2 * h + 2 * hkv)
    flops = 4 * b * h * d * attended_pairs(s, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (peak or PEAK_FLOPS[product_rate(dtype)])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def product_rate(dtype):
    """PEAK_FLOPS's key for K3's and K4's products in ``dtype``: bf16 at the
    bf16 tensor-core peak, fp32 at three TF32 passes (``float32_tc``)."""
    return "bfloat16" if dtype == "bfloat16" else "float32_tc"


def qkv(b, s, h, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device="cuda").to(dt)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def main_path_cases():
    """(name, B, S, H, Hkv, d, window, dtype) of every K3 call the main paths
    make: the Engine prefill and each SlotServer prefill, in bf16, at
    llama2-7b's heads and (named ``moe_*``) at deepseek-moe-16b's, whose
    path serves the same traffic; and frontends_main's 640-position
    prefills at llava-v1.5-7b's, internvl2-2b's and musicgen-medium's
    heads (d = 64)."""
    from repro_torch.configs import get_arch

    cases = []
    for prefix, arch in (("", ARCH), ("moe_", MOE_ARCH)):
        cfg = get_arch(arch)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        cases += [(f"{prefix}engine_prefill", ENGINE_BATCH, ENGINE_PROMPT, h, hkv, d, 0,
                   "bfloat16")]
        cases += [(f"{prefix}slot_prefill_s{n}", 1, n, h, hkv, d, 0, "bfloat16")
                  for n in SLOT_PROMPTS]
    for arch in FRONTEND_ARCHS:                  # frontends_main's prefills
        cfg = get_arch(arch)
        cases += [(f"{arch.split('-')[0]}_prefill", ENGINE_BATCH, FRONTEND_PROMPT, cfg.n_heads,
                   cfg.n_kv_heads, cfg.d_head, 0, "bfloat16")]
    return cases


# Beyond the main path: (name, B, S, H, Hkv, d, window, dtype)
EXTRA_CASES = [
    ("long_prompt", 1, 2048, 32, 32, 128, 0, "bfloat16"),
    ("gemma_window_4k", 1, 4096, 32, 16, 128, 1024, "bfloat16"),
    ("gqa_d64", 2, 256, 32, 4, 64, 0, "bfloat16"),
    ("ragged", 2, 200, 8, 8, 128, 0, "bfloat16"),
    ("window", 2, 300, 8, 2, 64, 96, "bfloat16"),
    ("d32_window", 2, 130, 4, 4, 32, 24, "bfloat16"),
    ("main_path_fp32", 1, 64, 32, 32, 128, 0, "float32"),
    ("long_prompt_fp32", 1, 2048, 32, 32, 128, 0, "float32"),
    # the fp32 calls FP32_K3_TIMED times: launch.serve's defaults, its
    # llama2-7b prefill (serve_fp32) and train_sharded's prefill
    ("serve_default_fp32", 4, 16, 32, 4, 64, 0, "float32"),
    ("engine_prefill_fp32", 4, 64, 32, 32, 128, 0, "float32"),
    ("sharded_prefill_fp32", 4, 512, 32, 32, 128, 0, "float32"),
    ("gqa_d64_fp32", 2, 256, 32, 4, 64, 0, "float32"),
    ("ragged_window_fp32", 2, 200, 8, 2, 128, 48, "float32"),
    ("d16_fp32", 2, 100, 4, 2, 16, 0, "float32"),
]


# Two probes, built beside the kernels with the same flags: the float64
# exp() sequence, whose SASS is counted for K2's bound, and an empty kernel
# launched through the same kind of C entry point as the port's kernels
# (the launch floor of a ctypes call).
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
extern "C" __global__ void exp_probe(const double* x, double* y) {
  y[threadIdx.x] = exp(x[threadIdx.x]);
}
__global__ void empty_probe() {}
extern "C" int probe_empty(int device, void* stream) {
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  empty_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  err = (int)cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return err;
}
"""


def start_probe_build():
    """Start nvcc on PROBE_SOURCE into the kernels' build directory; returns
    (process, library path)."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "chip_smoke_probe.cu"
    src.write_text(PROBE_SOURCE)
    out = build.BUILD_DIR / "chip_smoke_probe.so"
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_probe_build(started):
    proc, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed: nvcc exited {proc.returncode}\n{stdout}{stderr}")
    return out


def sass_of(path):
    from repro_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def exp_f64_instructions(probe):
    """Float64 instructions (DFMA, DADD, DMUL, DSETP) of ``exp_probe``: up
    to its first EXIT (the path an argument in range takes) and in all."""
    import re

    fast = total = 0
    inside = ended = False
    for line in sass_of(probe).splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() == "exp_probe"
            continue
        if not inside:
            continue
        if re.search(r"\b(DFMA|DADD|DMUL|DSETP)\b", line):
            total += 1
            fast += not ended
        if re.search(r"\bEXIT\b", line):
            ended = True
    return {"fast_path": fast, "all": total}


def ptxas_resources(log, name_of=None):
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    ``-Xptxas -v`` report, kernel names as ``name_of`` (by default
    ``gp_kernel_name``) gives them."""
    import re

    name_of = name_of or gp_kernel_name
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(name_of(m[1]), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def phase_k3_sass(info):
    """Tensor-core (HGMMA, HMMA) and TMA (UTMALDG) instructions in each K3
    instantiation's SASS, by ``cuobjdump`` beside ``nvcc``; every bf16
    instantiation must have HGMMA and UTMALDG, every fp32 one HMMA (its
    TF32 ``mma.sync``): no CUDA-core-only instantiation is left."""
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(info.path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwd_(bf16|fp32)ILi(\d+)E", line)
            cur = (counts.setdefault(f"{m[1]}_d{m[2]}", {"HGMMA": 0, "HMMA": 0, "UTMALDG": 0})
                   if m else None)
        elif cur is not None:
            for op in cur:
                cur[op] += bool(re.search(rf"\b{op}\b", line))
    emit("k3_sass", counts=counts, resources=ptxas_resources(info.log, k3_kernel_name))
    need = {"bf16": ("HGMMA", "UTMALDG"), "fp32": ("HMMA",)}
    lacking = [f"{dt}_d{d}" for dt, ops in need.items() for d in SUPPORTED_HEAD_DIMS
               if any(counts.get(f"{dt}_d{d}", {}).get(op, 0) == 0 for op in ops)]
    if lacking:
        raise AssertionError(f"K3 instantiations without their tensor-core instructions "
                             f"(bf16: HGMMA, UTMALDG; fp32: HMMA): {lacking}")


def k3_kernel_name(mangled):
    """``bf16_d128`` or ``fp32_d64`` from a mangled K3 kernel name."""
    import re

    m = re.search(r"flash_fwd_(bf16|fp32)ILi(\d+)E", mangled)
    return f"{m[1]}_d{m[2]}" if m else mangled


def gp_kernel_name(mangled):
    """``gp_fold_kernel<true>`` from an Itanium-mangled gp_ops kernel name:
    the identifier is the ``gp_...`` run whose decimal length prefix ends
    just before it (the digits before may join a hex namespace tag)."""
    import re

    for m in re.finditer(r"(\d+)(gp_\w*)", mangled):
        digits, rest = m[1], m[2]
        for k in range(1, len(digits) + 1):
            name = rest[:int(digits[-k:])]
            if name.endswith("_kernel"):
                arg = re.match(r"IL([bi])(\d+)EE", rest[len(name):])
                if arg is None:
                    return name
                value = {"0": "false", "1": "true"}[arg[2]] if arg[1] == "b" else arg[2]
                return f"{name}<{value}>"
    return mangled


def phase_gp_sass(info, probe):
    """Float64 tensor-core (DMMA) instructions in each gp_ops kernel's SASS,
    by ``cuobjdump`` beside ``nvcc``; both fold products and K2's partial
    pass must have them.  K2's two kernels' registers and spills (``-Xptxas -v``): none may
    spill.  Returns the float64 instructions of one exp() (the probe)."""
    import re

    counts, cur = {}, None
    for line in sass_of(info.path).splitlines():
        if "Function :" in line:
            cur = gp_kernel_name(line.split("Function :")[1].strip())
            counts[cur] = 0
        elif cur is not None and re.search(r"\bDMMA", line):
            counts[cur] += 1
    res = ptxas_resources(info.log)
    k2 = {k: res.get(k) for k in ("gp_ehvi_partial_kernel", "gp_ehvi_sweep_kernel")}
    exp_f64 = exp_f64_instructions(probe)
    emit("gp_sass", dmma=counts, k2_resources=k2, exp_f64_instructions=exp_f64)
    folds = [k for k in counts if k.startswith("gp_fold_kernel<")]
    if len(folds) != 2 or min(counts[k] for k in folds) == 0:
        raise AssertionError(f"the fold products lack DMMA instructions: {counts}")
    if not counts.get("gp_ehvi_partial_kernel"):
        raise AssertionError(f"K2's contraction lacks DMMA instructions: {counts}")
    if any(r is None or "registers" not in r or r.get("spill_stores") != 0
           or r.get("spill_loads") != 0 for r in k2.values()):
        raise AssertionError(f"K2's kernels spill or were not reported: {k2}")
    if exp_f64["fast_path"] == 0:
        raise AssertionError(f"no float64 instructions counted in exp(): {exp_f64}")
    return exp_f64["fast_path"]


def ssd_kernel_name(mangled):
    """``bf16_chunk_p64``, ``fp32_chunk_p64``, ``bf16_state_pass`` or
    ``fp32_state_pass`` from a mangled K4 kernel name (the chunk kernel's
    second template argument, the state pass's one, is the dtype: ``f`` or
    ``__nv_bfloat16``)."""
    import re

    m = re.search(r"ssd_chunk_kernelILi(\d+)E(f|13__nv_bfloat16)E", mangled)
    if m:
        return f"{'fp32' if m[2] == 'f' else 'bf16'}_chunk_p{m[1]}"
    m = re.search(r"ssd_state_kernelI(f|13__nv_bfloat16)E", mangled)
    if m:
        return f"{'fp32' if m[1] == 'f' else 'bf16'}_state_pass"
    return "shared_memory_fill" if "fill_smem_kernel" in mangled else mangled


def phase_ssd_sass(info):
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in each K4
    instantiation's SASS, by ``cuobjdump``, with its registers and spills
    (``-Xptxas -v``); every chunk kernel (one per P and dtype: bf16's
    m16n8k16, fp32's TF32 m16n8k8) must have HMMA."""
    import re

    from repro_torch.kernels.ssd_scan import SUPPORTED_HEAD_DIMS

    counts, cur = {}, None
    for line in sass_of(info.path).splitlines():
        if "Function :" in line:
            cur = counts.setdefault(ssd_kernel_name(line.split("Function :")[1].strip()),
                                    {"HMMA": 0, "HGMMA": 0})
        elif cur is not None:
            for op in cur:
                cur[op] += bool(re.search(rf"\b{op}\b", line))
    emit("ssd_sass", counts=counts, resources=ptxas_resources(info.log, ssd_kernel_name))
    lacking = [f"{dt}_chunk_p{p}" for dt in ("bf16", "fp32") for p in SUPPORTED_HEAD_DIMS
               if counts.get(f"{dt}_chunk_p{p}", {"HMMA": 0})["HMMA"] == 0]
    if lacking:
        raise AssertionError(f"K4 chunk kernels without HMMA: {lacking}")


def phase_parity():
    """K3 against its plain version on every case: at TOL (the plain version
    forms bf16 logits as the reference oracle does), and for bf16 also
    against the plain version in fp32 on the same inputs at BF16_VS_FP32,
    for fp32 against its mirror (three TF32 passes in plain PyTorch) at
    TOL; launched twice on the same inputs, bitwise equal."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    errs = {}
    for i, (name, b, s, h, hkv, d, window, dtype) in enumerate(main_path_cases() + EXTRA_CASES):
        q, k, v = qkv(b, s, h, hkv, d, dtype, seed=100 + i)
        first = fa.flash_attention(q, k, v, causal=True, window=window)
        again = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(first, again))
        got = first.float()
        del again
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window).float()
        err = (got - want).abs().max().item()
        tol = TOL[dtype]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol)) and repeat
        extra = {"bitwise_repeat": repeat}
        if dtype == "float32":
            mirror = fa.flash_attention_mirror_fp32(q, k, v, causal=True, window=window)
            ok_m = bool(torch.allclose(got, mirror, atol=tol, rtol=tol))
            extra.update(max_abs_err_vs_mirror=(got - mirror).abs().max().item(), ok_vs_mirror=ok_m)
            ok = ok and ok_m
            del mirror
        if dtype == "bfloat16":
            want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                              causal=True, window=window)
            ok32 = bool(torch.allclose(got, want32, **BF16_VS_FP32))
            extra.update(max_abs_err_vs_fp32=(got - want32).abs().max().item(),
                         tol_vs_fp32=BF16_VS_FP32, ok_vs_fp32=ok32)
            ok = ok and ok32
        emit("parity", kernel="flash_attention", case=name, shape=[b, s, h, hkv, d],
             window=window, dtype=dtype, max_abs_err=err, tol=tol, ok=ok, **extra)
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version on {name}")
        errs[name] = err
    return errs


def same_weights(model, flags, cast=None):
    """A second Model over the same weights with other build flags: the same
    tensors, or copies cast to ``cast``."""
    from repro_torch.models import Model

    twin = Model(model.cfg, flags, device="meta", seed=None)
    sd = model.state_dict()
    if cast is not None:
        sd = {k: v.to(cast) for k, v in sd.items()}
    twin.load_state_dict(sd, assign=True)
    return twin


def phase_two_layer_gap(seed):
    """flash vs the plain grouped path on a 2-layer llama2-7b at full width in
    bf16: max |dlogit| at most 5 % of max |logit|."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import BuildFlags, Model

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=2)
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    model = Model(cfg, flags, device="cuda", seed=seed)
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64))
    with torch.inference_mode():
        gap = logits_gap(model.prefill({"tokens": tokens})[0],
                         xla.prefill({"tokens": tokens})[0])
    emit("outputs", n_layers=2, flash_vs_xla=gap)
    if not gap["finite"] or gap["max_abs_diff"] > 0.05 * gap["max_abs_logit"]:
        raise AssertionError(f"2-layer flash and xla prefill logits differ: {gap}")


def logits_gap(a, b):
    import torch

    a, b = a.float(), b.float()
    return {"max_abs_diff": (a - b).abs().max().item(),
            "rms_diff": (a - b).pow(2).mean().sqrt().item(),
            "max_abs_logit": b.abs().max().item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all())}


def phase_main_path(n_layers, seed):
    """llama2-7b at full width in bf16 with flash attention, served through
    ``serve_path``; K3's launches must equal the attention layers times the
    prefill calls.  Drift gate: the flash path and the plain grouped path,
    each against an fp32 copy of the weights on the plain path."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import BuildFlags, Model

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=n_layers)
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    t0 = time.perf_counter()
    model = Model(cfg, flags, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", arch=cfg.name, n_layers=n_layers, d_model=cfg.d_model,
         params=n_params, weight_bytes=n_params * 2,
         seconds=time.perf_counter() - t0)
    slot_new = list(SLOT_NEW)
    n_attn = sum(1 for s in cfg.layer_specs() if s.mixer in ("attn", "attn_local"))

    # ---- the main path, with every kernel's launch count set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = k6.decode_attention.launches = 0
    tokens, _, gen_s, slot_s, calls = serve_path(model, SLOT_PROMPTS, slot_new, 128, seed)
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": k6.decode_attention.launches}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()

    want = n_attn * calls["prefill"]
    emit("main_path", engine_seconds=gen_s, slot_server_seconds=slot_s, calls=calls,
         launches=launches, expected_flash_launches=want,
         expected_decode_launches=n_attn * calls["decode"], max_memory_allocated=peak)
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} "
                             f"times on the main path, expected {want}")
    if launches["decode_attention"] != n_attn * calls["decode"]:
        raise AssertionError(f"decode_attention launched {launches['decode_attention']} "
                             f"times on the main path, expected {n_attn * calls['decode']}")

    # ---- outputs: over 32 bf16 layers both bf16 paths drift from fp32; the
    # flash path must not drift further than DRIFT_RATIO times as far
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    with torch.inference_mode():
        lf, _ = model.prefill({"tokens": tokens})
        lx, _ = xla.prefill({"tokens": tokens})
        ref = same_weights(model, dataclasses.replace(flags, attn_impl="xla", dtype="float32"),
                           cast=torch.float32)
        lr, _ = ref.prefill({"tokens": tokens})
        del ref
    drift_gate(lf, lx, lr, "main_path", names=("flash", "xla"), n_layers=n_layers)
    del xla
    torch.cuda.empty_cache()

    # ---- serving times (after the counted run, so they count no launches)
    serve_times(model, tokens, "main_path", gen_s, slot_s, slot_new, peak)
    del model
    torch.cuda.empty_cache()
    return launches


def profile(fn, calls=1, top=6):
    """Device kernel time per call of ``fn`` over ``calls`` calls, summed and
    by kernel name, and each kernel's time per recorded event (the trace
    may drop events of a kernel that launched once per call: §7 of
    PERF.md).

    Only the device-side kernel events are summed (the CPU-side operator
    events also carry the device time of the kernels they launch)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.device_time_total / 1e3 / calls
            by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"device_busy_ms": sum(ms for ms, _ in by_name.values()),
            "n_kernels": sum(n for _, n in by_name.values()) / calls,
            "top": [{"name": name[:72], "ms": ms, "calls": n / calls,
                     "ms_per_event": ms * calls / n}
                    for name, (ms, n) in ranked[:top]]}


def device_times(**fns):
    """``{key}_device_ms`` (profiler kernel time per call, over 10 calls) and
    ``{key}_kernels_per_call`` (kernel events recorded per call) for each
    function: a count below the kernels the call launches (one for most
    wrappers; K1a three at a fold and two at a tell, K1b two) says the
    trace dropped launches and the time per call reads low."""
    out = {}
    for key, fn in fns.items():
        p = profile(fn, calls=10)
        out[f"{key}_device_ms"] = p["device_busy_ms"]
        out[f"{key}_kernels_per_call"] = p["n_kernels"]
    return out


def phase_small_reference():
    """On a small fp32 model: SlotServer equals Engine token for token, and the
    flash and plain grouped prefill logits agree at 5e-5."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import BuildFlags, Model
    from repro_torch.serve import Engine, SlotServer

    cfg = reduced(get_arch("llama2-7b"))
    flags = BuildFlags(dtype="float32", attn_impl="flash")
    model = Model(cfg, flags, device="cuda", seed=0)
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with torch.inference_mode():
        lf, _ = model.prefill({"tokens": toks})
        lx, _ = xla.prefill({"tokens": toks})
    diff = (lf - lx).abs().max().item()
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 7)]
    new = [6, 4, 8]
    srv = SlotServer(model, n_slots=2, max_len=48)
    for i, (p, n) in enumerate(zip(prompts, new)):
        srv.submit(i, p, n)
    got = {r.rid: r.out for r in srv.run()}
    same = all(got[i] == Engine(model, max_len=48).generate({"tokens": p[None]}, n)
               .tokens[0].tolist() for i, (p, n) in enumerate(zip(prompts, new)))
    emit("small_reference", flash_vs_xla_max_abs_diff=diff, slot_server_equals_engine=same)
    if diff > 5e-5 or not same:
        raise AssertionError("small fp32 model: flash/xla or SlotServer/Engine disagree")


def sdpa(q, k, v, window):
    """The one PyTorch call that computes K3's function on (B, S, H, d)
    inputs: ``scaled_dot_product_attention`` on (B, H, S, d) copies, causal;
    with GQA or a window, ``enable_gqa`` and an explicit boolean mask (a
    window has no ``is_causal`` form, so another backend serves it)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not window and k.shape[2] == q.shape[2]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= (i[:, None] - i[None, :]) < window
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_times(errs, launches):
    import torch

    from repro_torch.kernels import flash_attention as fa

    rows = {}
    timed = ("slot_prefill_s64", "engine_prefill", "long_prompt", "gemma_window_4k",
             "llava_prefill", "musicgen_prefill")
    for name, b, s, h, hkv, d, window, dtype in main_path_cases() + EXTRA_CASES:
        if name not in timed:
            continue
        q, k, v = qkv(b, s, h, hkv, d, dtype, seed=7)
        library = sdpa(q, k, v, window)
        # The yardstick must compute K3's function.
        lib_err = (library().transpose(1, 2).float()
                   - fa.flash_attention_plain(q, k, v, window=window).float()).abs().max().item()
        if lib_err > TOL[dtype]:
            raise AssertionError(f"SDPA is off K3's plain version by {lib_err} on {name}")
        iters = 200 if s <= 256 else 20
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, window=window), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, window=window), iters)
        lib_ms = cuda_ms(library, iters)
        bound_ms, bound_by = flash_bound(b, s, h, hkv, d, window, dtype)
        # Device time of one call from the profiler: at small shapes the
        # event-timed loops above are bound by the host's launch rate.
        device = device_times(
            kernel=lambda: fa.flash_attention(q, k, v, window=window),
            plain=lambda: fa.flash_attention_plain(q, k, v, window=window),
            library=library)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_single_ms=single_ms(lambda: fa.flash_attention(q, k, v, window=window)),
                          library_max_abs_err=lib_err, **device)
        emit("time", kernel="flash_attention", case=name, shape=[b, s, h, hkv, d],
             dtype=dtype, window=window, grid=[-(-s // fa.tiles(d, q.dtype)["block_q"]), b * h],
             **rows[name])
    emit("k3_tiles", **{f"{dt}_d{d}": fa.tiles(d, getattr(torch, dt))
                        for dt in ("bfloat16", "float32") for d in fa.SUPPORTED_HEAD_DIMS})
    main = rows["slot_prefill_s64"]
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:31",
             "launches": launches["flash_attention"],
             "max_abs_err": max(errs[c[0]] for c in main_path_cases()),
             "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": main["library_ms"]}]

# ---------------------------------------------------------------------------
# The Mamba-2 path (K4) and the MoE path (K5, with K3)
# ---------------------------------------------------------------------------


def ssd_inputs(b, s, h, p, n, dtype, seed):
    """K4's inputs as the reference's kernel tests draw them: dt = softplus,
    a_log = -dt * sigmoid, b and c at 0.4 N(0, 1); x, b, c in ``dtype``."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = F.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    a_log = -dt * torch.sigmoid(torch.randn((b, s, h), generator=g, device="cuda"))
    cast = getattr(torch, dtype)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(cast)
    bb = (0.4 * torch.randn((b, s, n), generator=g, device="cuda")).to(cast)
    cc = (0.4 * torch.randn((b, s, n), generator=g, device="cuda")).to(cast)
    return x, a_log, bb, cc, dt


def ssd_main_path_cases():
    """(name, B, S, H, P, N, chunk, dtype) of every K4 call the Mamba path
    makes: the Engine prefill and each SlotServer prefill, at mamba2-780m's
    widths in bf16."""
    from repro_torch.configs import get_arch

    cfg = get_arch(SSM_ARCH)
    h, p, n, q = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    return ([("engine_prefill", ENGINE_BATCH, ENGINE_PROMPT, h, p, n, q, "bfloat16")]
            + [(f"slot_prefill_s{s}", 1, s, h, p, n, q, "bfloat16") for s in SSM_SLOT_PROMPTS])


# Beyond the main path: tests/test_kernels.py's grid (fp32), a jamba-like
# head, an fp32 600-token call, and the bf16 kernel at an odd head count, a
# small chunk and an odd chunk
SSD_EXTRA_CASES = [
    ("grid_s64", 2, 64, 2, 16, 16, 16, "float32"),
    ("grid_s96", 2, 96, 4, 32, 32, 32, "float32"),
    ("grid_s40_pad", 2, 40, 1, 16, 64, 16, "float32"),
    ("jamba_like", 1, 300, 128, 64, 16, 256, "bfloat16"),
    ("mamba_s600_fp32", 1, 600, 48, 64, 128, 256, "float32"),
    ("h5_odd_heads", 6, 600, 5, 64, 128, 64, "bfloat16"),
    ("chunk8", 1, 100, 4, 64, 128, 8, "bfloat16"),           # 13 chunks of 8
    ("chunk75_odd", 4, 600, 48, 64, 128, 75, "bfloat16"),    # 8 chunks of 75
    # the fp32 tensor-core path: serve_fp32's prefill, sharded_ssm's, and the
    # bf16 cases' odd heads and chunks
    ("engine_prefill_fp32", 4, 64, 48, 64, 128, 256, "float32"),
    ("sharded_prefill_fp32", 4, 512, 48, 64, 128, 256, "float32"),
    ("h5_odd_heads_fp32", 6, 600, 5, 64, 128, 64, "float32"),
    ("chunk8_fp32", 1, 100, 4, 64, 128, 8, "float32"),
    ("chunk75_odd_fp32", 4, 600, 48, 64, 128, 75, "float32"),
]


def phase_ssd_parity():
    """K4 against its plain version: y at TOL[dtype] (fp32 at SSD_TOL), the
    fp32 final state at SSD_TOL, a bf16 y also against the plain version run
    in fp32 on the same inputs at one bf16 rounding (BF16_VS_FP32), an fp32
    call against its mirror (three TF32 passes) at SSD_TOL, and two
    launches on the same inputs bitwise equal; every SM's shared memory is
    filled with NaN before each launch, which the kernel must not read."""
    import torch

    from repro_torch.kernels import ssd_scan as k4

    errs = {}
    for i, (name, b, s, h, p, n, chunk, dtype) in enumerate(ssd_main_path_cases()
                                                          + SSD_EXTRA_CASES):
        args = ssd_inputs(b, s, h, p, n, dtype, seed=200 + i)
        k4.fill_shared_memory(float("nan"), 0)
        y, state = k4.ssd_scan(*args, chunk=chunk)
        k4.fill_shared_memory(float("nan"), 0)
        y2, state2 = k4.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        q = k4.clamp_chunk(chunk, s)
        want_y, want_state = k4.ssd_scan_plain(*args, chunk=q)
        y_tol = TOL[dtype] if dtype == "bfloat16" else SSD_TOL
        err_y = (y.float() - want_y.float()).abs().max().item()
        err_s = (state - want_state).abs().max().item()
        ok = bool(torch.allclose(y.float(), want_y.float(), atol=y_tol, rtol=y_tol)
                  and torch.allclose(state, want_state, atol=SSD_TOL, rtol=SSD_TOL))
        repeat = bool(torch.equal(y, y2) and torch.equal(state, state2))
        extra = {}
        if dtype == "bfloat16":
            x32, a32, b32, c32, d32 = (t.float() for t in args)
            want32, _ = k4.ssd_scan_plain(x32, a32, b32, c32, d32, chunk=q)
            ok32 = bool(torch.allclose(y.float(), want32, **BF16_VS_FP32))
            extra = dict(max_abs_err_vs_fp32=(y.float() - want32).abs().max().item(),
                         tol_vs_fp32=BF16_VS_FP32, ok_vs_fp32=ok32)
            ok = ok and ok32
        else:
            my, mst = k4.ssd_scan_mirror(*args, chunk=q)
            ok_m = bool(torch.allclose(y, my, atol=SSD_TOL, rtol=SSD_TOL)
                        and torch.allclose(state, mst, atol=SSD_TOL, rtol=SSD_TOL))
            extra = dict(max_abs_err_vs_mirror=max((y - my).abs().max().item(),
                                                   (state - mst).abs().max().item()),
                         ok_vs_mirror=ok_m)
            ok = ok and ok_m
        ok = ok and repeat
        emit("parity", kernel="ssd_scan", case=name, shape=[b, s, h, p, n], chunk=q,
             n_chunks=-(-s // q), dtype=dtype, max_abs_err=err_y, state_max_abs_err=err_s,
             tol=y_tol, state_tol=SSD_TOL, bitwise_repeat=repeat, ok=ok, **extra)
        if not ok:
            raise AssertionError(f"ssd_scan disagrees with its plain version on {name}")
        errs[name] = max(err_y, err_s)
    return errs


def topk_main_path_cases():
    """(name, T, E, k) of the K5 calls the MoE path makes: the Engine's
    prefill (B*S tokens) and decode (B), each slot prefill (its prompt) and
    the SlotServer's decode (its slots)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(MOE_ARCH)
    e, k = cfg.n_experts, cfg.moe_top_k
    return ([("engine_prefill", ENGINE_BATCH * ENGINE_PROMPT, e, k),
             ("engine_decode", ENGINE_BATCH, e, k), ("slot_decode", 2, e, k)]
            + [(f"slot_prefill_s{n}", n, e, k) for n in SLOT_PROMPTS])


def phase_topk_parity():
    """K5 against its plain version: ids equal, probabilities within
    TOPK_P_TOL, on random logits, rows with exact ties (logits on a 0.5
    grid) and T off any block; two launches bitwise equal."""
    import torch

    from repro_torch.kernels import topk_gating as k5

    cases = [(name, t, e, k, False) for name, t, e, k in topk_main_path_cases()]
    cases += [("train_moe", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 64, 6, False),   # train_main (b)
              ("train_moe_ties", MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, 64, 6, True),
              ("engine_prefill_ties", 256, 64, 6, True), ("t1", 1, 64, 6, False),
              ("t37_ties", 37, 64, 6, True), ("t1000_e16", 1000, 16, 4, False),
              ("e256_k8", 33, 256, 8, False), ("e4_k4_ties", 40, 4, 4, True)]
    err = 0.0
    for i, (name, t, e, k, ties) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        logits = torch.randn((t, e), generator=g, device="cuda")
        if ties:
            logits = torch.round(logits * 2) / 2
        p, ids = k5.topk_gating(logits, k)
        p2, ids2 = k5.topk_gating(logits, k)
        torch.cuda.synchronize()
        want_p, want_ids = k5.topk_gating_plain(logits, k)
        e_p = (p - want_p).abs().max().item()
        same = bool(torch.equal(ids, want_ids))
        repeat = bool(torch.equal(p, p2) and torch.equal(ids, ids2))
        ok = same and repeat and e_p <= TOPK_P_TOL
        emit("parity", kernel="topk_gating", case=name, shape=[t, e, k], ties=ties,
             max_abs_err=e_p, tol=TOPK_P_TOL, ids_equal=same, bitwise_repeat=repeat, ok=ok)
        if not ok:
            raise AssertionError(f"topk_gating disagrees with its plain version on {name}")
        err = max(err, e_p)
    return err


def drift_gate(kernel_logits, plain_logits, ref_logits, label, metric="max_abs_diff",
               names=("kernel", "plain"), **fields):
    """The bf16 kernel path may sit at most DRIFT_RATIO times as far from the
    fp32 reference as the bf16 plain path (``metric`` of the differences).
    ``names`` label the two paths in the emitted gaps."""
    kn, pn = names
    gaps = {f"{kn}_vs_{pn}": logits_gap(kernel_logits, plain_logits),
            f"{kn}_vs_fp32": logits_gap(kernel_logits, ref_logits),
            f"{pn}_vs_fp32": logits_gap(plain_logits, ref_logits)}
    emit("outputs", path=label, metric=metric, **fields, **gaps)
    if not all(g["finite"] for g in gaps.values()) or (
            gaps[f"{kn}_vs_fp32"][metric] > DRIFT_RATIO * gaps[f"{pn}_vs_fp32"][metric]):
        raise AssertionError(f"{label}: the bf16 kernel path is off the fp32 reference: {gaps}")


def serve_path(model, slot_prompts, slot_new, slot_max_len, seed):
    """Engine.generate on ENGINE_BATCH x ENGINE_PROMPT, then a SlotServer with
    2 slots over ``slot_prompts``: returns (tokens, Engine s, SlotServer s,
    finished requests, prefill and decode calls).  The callers reset the
    kernels' counts just before and read them just after."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, SlotServer

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (ENGINE_BATCH, ENGINE_PROMPT)).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in slot_prompts]
    calls = {"prefill": 0, "decode": 0}
    for name in calls:
        inner = getattr(model, {"prefill": "prefill", "decode": "decode_step"}[name])

        def counted(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)
        setattr(model, {"prefill": "prefill", "decode": "decode_step"}[name], counted)
    engine = Engine(model, max_len=ENGINE_PROMPT + ENGINE_NEW + 1)
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, ENGINE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    srv = SlotServer(model, n_slots=2, max_len=slot_max_len)
    for i, (p, n) in enumerate(zip(prompts, slot_new)):
        srv.submit(i, p, n)
    t0 = time.perf_counter()
    finished = srv.run()
    torch.cuda.synchronize()
    slot_s = time.perf_counter() - t0
    del model.prefill, model.decode_step            # back to the class's methods
    if res.tokens.shape != (ENGINE_BATCH, ENGINE_NEW) or not (
            (res.tokens >= 0).all() and (res.tokens < cfg.vocab_size).all()):
        raise AssertionError(f"{cfg.name}: Engine tokens wrong: shape {res.tokens.shape}")
    if sorted(r.rid for r in finished) != list(range(len(prompts))) or any(
            len(r.out) != slot_new[r.rid] for r in finished):
        raise AssertionError(f"{cfg.name}: SlotServer did not finish every request")
    return tokens, prompts, gen_s, slot_s, calls


def serve_times(model, tokens, label, gen_s, slot_s, slot_new, peak):
    """Prefill ms, decode ms per token (CUDA events), the profiler's busy
    share, tokens/s and peak memory of one served path."""
    import torch

    from repro_torch.serve.engine import pad_caches

    batch, prompt, n_gen = ENGINE_BATCH, ENGINE_PROMPT, ENGINE_NEW
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.prefill({"tokens": tokens}), iters=5, warmup=1)
        _, caches = model.prefill({"tokens": tokens})
        caches = pad_caches(caches, prompt, prompt + n_gen + 1)
        tok = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
        steps = iter(range(prompt, prompt + n_gen))
        decode_ms = cuda_ms(lambda: model.decode_step(tok, caches, next(steps)),
                            iters=n_gen - 4, warmup=2)
        prof_prefill = profile(lambda: model.prefill({"tokens": tokens}))
        prof_decode = profile(lambda: model.decode_step(tok, caches, prompt + 1))
    emit("profile", path=label, step="prefill", batch=batch, prompt=prompt,
         device_busy_share=prof_prefill["device_busy_ms"] / prefill_ms, **prof_prefill)
    emit("profile", path=label, step="decode", batch=batch,
         device_busy_share=prof_decode["device_busy_ms"] / decode_ms, **prof_decode)
    emit("serve", path=label, batch=batch, prompt=prompt, n_gen=n_gen,
         prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
         generate_tokens_per_s=batch * n_gen / gen_s,
         slot_server_tokens_per_s=sum(slot_new) / slot_s, max_memory_allocated=peak)


def phase_ssm_main(seed):
    """mamba2-780m at full width and depth (48 layers), bf16, K4 on the
    prefills: Engine and SlotServer; K4's launches must equal 48 x prefills.
    Drift gate: the bf16 K4 path and the bf16 plain chunked path, each
    against an fp32 copy of the weights on the plain path, at the Engine's
    (4, 64) and at one 600-token prompt (3 chunks)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import BuildFlags, Model

    cfg = get_arch(SSM_ARCH)
    flags = BuildFlags(dtype="bfloat16", ssd_impl="cuda")
    t0 = time.perf_counter()
    model = Model(cfg, flags, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         d_inner=cfg.d_inner, params=n_params, seconds=time.perf_counter() - t0)
    slot_new = list(SLOT_NEW)
    n_mamba = sum(1 for s in cfg.layer_specs() if s.mixer == "mamba")

    # ---- the main path, with every kernel's launch count set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    for kern in (k4.ssd_scan, k5.topk_gating, fa.flash_attention):
        kern.launches = 0
    tokens, _, gen_s, slot_s, calls = serve_path(
        model, SSM_SLOT_PROMPTS, slot_new, max(SSM_SLOT_PROMPTS) + max(slot_new) + 2, seed)
    launches = {"ssd_scan": k4.ssd_scan.launches, "topk_gating": k5.topk_gating.launches,
                "flash_attention": fa.flash_attention.launches}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    want = n_mamba * calls["prefill"]
    emit("main_ssm", arch=cfg.name, engine_seconds=gen_s, slot_server_seconds=slot_s,
         calls=calls, launches=launches, expected_ssd_launches=want,
         max_memory_allocated=peak)
    if launches != {"ssd_scan": want, "topk_gating": 0, "flash_attention": 0}:
        raise AssertionError(f"mamba path launches {launches}, expected ssd_scan {want}")

    plain = same_weights(model, dataclasses.replace(flags, ssd_impl="jnp"))
    ref = same_weights(model, dataclasses.replace(flags, ssd_impl="jnp", dtype="float32"),
                       cast=torch.float32)
    long = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (1, 600))
    for toks in (tokens, long):
        with torch.inference_mode():
            lk, _ = model.prefill({"tokens": toks})
            lp, _ = plain.prefill({"tokens": toks})
            lr, _ = ref.prefill({"tokens": toks})
        drift_gate(lk, lp, lr, "main_ssm", n_layers=cfg.n_layers, shape=list(toks.shape))
    del plain, ref
    torch.cuda.empty_cache()
    serve_times(model, tokens, "main_ssm", gen_s, slot_s, slot_new, peak)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_moe_main(seed):
    """deepseek-moe-16b at full width and depth (28 layers), bf16, flash
    attention: Engine and SlotServer with the llama2-7b traffic.  K5's
    launches must equal 27 MoE layers x forward calls, K3's 28 x prefills.
    The router logits K5 received are recorded and replayed through its
    plain version.  Drift gate on a 4-layer full-width copy."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models import moe as moe_mod

    cfg = get_arch(MOE_ARCH)
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    t0 = time.perf_counter()
    model = Model(cfg, flags, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, weight_bytes=n_params * 2, seconds=time.perf_counter() - t0)
    specs = cfg.layer_specs()
    n_moe = sum(1 for s in specs if s.ffn == "moe")
    n_attn = sum(1 for s in specs if s.mixer in ("attn", "attn_local"))
    slot_new = list(SLOT_NEW)

    # ---- the main path, with every kernel's launch count set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    for kern in (k4.ssd_scan, k5.topk_gating, fa.flash_attention, k6.decode_attention):
        kern.launches = 0
    tokens, _, gen_s, slot_s, calls = serve_path(model, SLOT_PROMPTS, slot_new, 128, seed)
    launches = {"ssd_scan": k4.ssd_scan.launches, "topk_gating": k5.topk_gating.launches,
                "flash_attention": fa.flash_attention.launches,
                "decode_attention": k6.decode_attention.launches}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    want = {"ssd_scan": 0, "topk_gating": n_moe * (calls["prefill"] + calls["decode"]),
            "flash_attention": n_attn * calls["prefill"],
            "decode_attention": n_attn * calls["decode"]}
    emit("main_moe", arch=cfg.name, engine_seconds=gen_s, slot_server_seconds=slot_s,
         calls=calls, launches=launches, expected=want, max_memory_allocated=peak)
    if launches != want:
        raise AssertionError(f"moe path launches {launches}, expected {want}")

    # ---- the same traffic again, untimed, with K5's inputs and outputs
    # recorded for the replay below (the copies would slow the timed run)
    seen = []
    real = moe_mod.topk_gating

    def recording(logits, k):
        out = real(logits, k)
        seen.append((logits.clone(), out[0].clone(), out[1].clone()))
        return out
    moe_mod.topk_gating = recording
    _, _, rec_gen_s, rec_slot_s, _ = serve_path(model, SLOT_PROMPTS, slot_new, 128, seed)
    moe_mod.topk_gating = real
    if len(seen) != want["topk_gating"]:
        raise AssertionError(f"the recorded run called K5 {len(seen)} times, "
                             f"expected {want['topk_gating']}")

    # ---- replay K5's recorded inputs through its plain version: ids equal
    # except where two neighbouring ranks' probabilities are within one ulp
    rows = mismatched = unexplained = 0
    p_err = 0.0
    for logits, p, ids in seen:
        k = ids.shape[1]
        want_p, want_ids = k5.topk_gating_plain(logits, k + 1)
        p_err = max(p_err, (p - want_p[:, :k]).abs().max().item())
        differ = (ids != want_ids[:, :k]).any(dim=1)
        rows += ids.shape[0]
        for r in torch.nonzero(differ).flatten().tolist():
            mismatched += 1
            j = int(torch.nonzero(ids[r] != want_ids[r, :k])[0])
            a, b = want_p[r, j], want_p[r, j + 1]
            if (a - b).abs() > (torch.nextafter(a, a + 1) - a):
                unexplained += 1
    emit("moe_routing_replay", calls=len(seen), rows=rows, rows_with_other_ids=mismatched,
         unexplained=unexplained, max_abs_p_err=p_err, tol=TOPK_P_TOL,
         recording_run_engine_seconds=rec_gen_s, recording_run_slot_server_seconds=rec_slot_s)
    if unexplained or p_err > TOPK_P_TOL:
        raise AssertionError(f"K5 on the main path disagrees with its plain version: "
                             f"{unexplained} rows, max |dp| {p_err}")
    del seen
    serve_times(model, tokens, "main_moe", gen_s, slot_s, slot_new, peak)
    del model
    torch.cuda.empty_cache()

    # ---- drift gate on a 4-layer full-width copy: the bf16 flash path and
    # the bf16 plain grouped path, each against an fp32 copy on the plain
    # path.  Routing in bf16 flips a token's expert where two gate
    # probabilities sit within bf16 noise, in either bf16 path, so the gate
    # compares root-mean-square distances (the max is reported beside it).
    cfg4 = dataclasses.replace(cfg, n_layers=MOE_DRIFT_LAYERS)
    small = Model(cfg4, flags, device="cuda", seed=seed)
    plain = same_weights(small, dataclasses.replace(flags, attn_impl="xla"))
    ref = same_weights(small, dataclasses.replace(flags, attn_impl="xla", dtype="float32"),
                       cast=torch.float32)
    with torch.inference_mode():
        lk, _ = small.prefill({"tokens": tokens})
        lp, _ = plain.prefill({"tokens": tokens})
        lr, _ = ref.prefill({"tokens": tokens})
    drift_gate(lk, lp, lr, "main_moe", n_layers=MOE_DRIFT_LAYERS, shape=list(tokens.shape),
               metric="rms_diff")
    del small, plain, ref
    torch.cuda.empty_cache()
    return launches


def ssd_bound(b, s, h, p, n, q, dtype, peak=None):
    """(bound_ms, bound_by) of one K4 call: x, a_log, dt, b, c read once, y
    and the fp32 state written once; operations as this call's chunks need
    them, C·Bᵀ once per (batch, chunk) (it is the same for every head), the
    rest per head: the causal S·X product, the incoming state's term and the
    state update, 2 flops a multiply-add, exp and the decay's 2 products as
    3 per (i, j) pair.  Over ``peak`` (by default the dtype's product rate),
    as for K3."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * 2 * b * s * h + 4 * b * h * p * n
    flops = 0
    for c0 in range(0, s, q):
        L = min(q, s - c0)
        pairs = L * (L + 1) // 2
        flops += b * 2 * n * pairs
        flops += b * h * (2 * p * pairs + 3 * pairs + 4 * n * p * L)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (peak or PEAK_FLOPS[product_rate(dtype)])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def topk_bound(t, e, k):
    """(bound_ms, bound_by) of one K5 call: the logits read once, p and ids
    written once; the softmax (max, exp, sum, divide: 4 per logit) and k
    compare-and-select steps (2 per logit each), fp32 off the tensor cores."""
    nbytes = 4 * t * e + 8 * t * k
    flops = t * e * (4 + 2 * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def host_us(fn, calls=10_000):
    """Host time per call of ``fn`` over ``calls`` calls, in µs
    (``perf_counter_ns``; the card synchronised only before and after the
    loop)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls / 1e3


def enqueue_us(fn, calls=200):
    """Host time per call of ``fn`` while the card works behind it, in µs:
    the loop is timed without a synchronisation at its end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    out = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return out


def topk_host_path(probe, logits, k):
    """K5's call path piece by piece at ``logits`` (µs per call over 10⁴
    calls each): the wrapper's checks, one ``torch.empty`` (the earlier
    wrapper made two), ``out_buffers`` and, beside it, one (2, T, k)
    allocation with a view per plane, a ``torch.cuda.device`` context (the
    earlier wrapper entered one), ``current_stream(...).cuda_stream`` and
    the raw accessor, the ctypes call with its launch, and an empty kernel
    launched through a ctypes call of the same kind (the launch floor).
    Then the whole wrapper and the earlier wrapper's steps
    (``earlier_path``) around the same entry point, in turns."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import topk_gating as k5

    lib = k5._lib()
    plib = ctypes.CDLL(str(probe))
    plib.probe_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    plib.probe_empty.restype = ctypes.c_int
    dev = logits.device
    idx = dev.index
    t, e = logits.shape
    p, ids = k5.out_buffers(logits, k)
    ptrs = (logits.data_ptr(), p.data_ptr(), ids.data_ptr())
    stream = build.current_stream(idx)
    if plib.probe_empty(idx, stream) or lib.topk_gating_fwd(*ptrs, t, e, k, idx, stream):
        raise AssertionError("the probe or K5 did not launch")

    def device_context():
        with torch.cuda.device(dev):
            pass

    def one_allocation_views():
        buf = torch.empty((2, t, k), dtype=torch.int32, device=dev)
        return buf[0].view(torch.float32), buf[1]

    def earlier_path():
        k5._check(logits, k)
        p2 = torch.empty((t, k), dtype=torch.float32, device=dev)
        ids2 = torch.empty((t, k), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            s = torch.cuda.current_stream(dev).cuda_stream
            lib.topk_gating_fwd(logits.data_ptr(), p2.data_ptr(), ids2.data_ptr(), t, e, k,
                                idx, s)
        return p2, ids2

    out = {
        "checks": host_us(lambda: k5._check(logits, k)),
        "torch_empty": host_us(lambda: torch.empty((t, k), dtype=torch.float32, device=dev)),
        "out_buffers": host_us(lambda: k5.out_buffers(logits, k)),
        "one_allocation_views": host_us(one_allocation_views),
        "device_context": host_us(device_context),
        "current_stream_object": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "current_stream_raw": host_us(lambda: build.current_stream(idx)),
        "ctypes_launch": host_us(lambda: lib.topk_gating_fwd(*ptrs, t, e, k, idx, stream)),
        "empty_kernel_ctypes": host_us(lambda: plib.probe_empty(idx, stream)),
    }
    turns = {"earlier_path": [], "wrapper": []}
    for key in ("earlier_path", "wrapper", "wrapper", "earlier_path"):
        fn = earlier_path if key == "earlier_path" else (lambda: k5.topk_gating(logits, k))
        turns[key].append(host_us(fn))
    out.update({k: min(v) for k, v in turns.items()}, turns=turns)
    return out


def graph_ms(fn, calls=20, replays=5):
    """Device time per call of ``fn`` with no host work between calls:
    ``calls`` calls captured in one CUDA graph, replayed ``replays`` times
    between CUDA events (the launches' own gaps inside a graph included)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def phase_new_times(ssd_errs, topk_err, ssm_launches, moe_launches, probe):
    """Times of K4 at each of its five serving-path shapes (the Engine's
    prefill and each slot prefill), and of K5 at the Engine's prefill
    (T = 256), beside their bounds and plain versions; K4's as a loop, one
    launch, the profiler's device time, the device time inside a CUDA graph
    (``graph_ms``) and the host enqueue per call, with the grid
    (``ssd_scan.schedule``); K5 also beside softmax + topk (two library
    calls) and its call path piece by piece (``topk_host_path``)."""
    import torch

    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5

    rows = {}
    for name, b, s, h, p, n, chunk, dtype in ssd_main_path_cases():
        args = ssd_inputs(b, s, h, p, n, dtype, seed=7)
        q = k4.clamp_chunk(chunk, s)
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, q, dtype)
        plan = k4.schedule(b, s, h, p, n, q)

        def kernel():
            return k4.ssd_scan(*args, chunk=chunk)

        def plain():
            return k4.ssd_scan_plain(*args, chunk=q)
        rows[name] = dict(ms=cuda_ms(kernel, 50), plain_ms=cuda_ms(plain, 50), library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
                          kernel_graph_ms=graph_ms(kernel),
                          kernel_graph_ms_repeat=graph_ms(kernel),
                          host_enqueue_us=enqueue_us(kernel),
                          **device_times(kernel=kernel, plain=plain))
        emit("time", kernel="ssd_scan", case=name, shape=[b, s, h, p, n], chunk=q, dtype=dtype,
             grid=plan["grids"], smem_bytes=k4.smem_bytes(p, n, q, getattr(torch, dtype)),
             **rows[name])

    name, t, e, k = topk_main_path_cases()[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    logits = torch.randn((t, e), generator=g, device="cuda")
    bound_ms, bound_by = topk_bound(t, e, k)

    def kernel():
        return k5.topk_gating(logits, k)

    def plain():
        return k5.topk_gating_plain(logits, k)

    def pair():
        return torch.topk(torch.softmax(logits, dim=-1), k)
    rows["topk"] = dict(ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 200), library_ms=None,
                        softmax_topk_two_calls_ms=cuda_ms(pair, 200),
                        bound_ms=bound_ms, bound_by=bound_by,
                        kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
                        **device_times(kernel=kernel, plain=plain, softmax_topk=pair))
    emit("time", kernel="topk_gating", case=name, shape=[t, e, k],
         grid=[-(-t // 8)], **rows["topk"])
    emit("topk_host_path", case=name, shape=[t, e, k], unit="us per call",
         **topk_host_path(probe, logits, k))
    main = rows["engine_prefill"]
    return [{"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:26",
             "launches": ssm_launches["ssd_scan"],
             "max_abs_err": max(ssd_errs[c[0]] for c in ssd_main_path_cases()),
             "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None},
            {"name": "topk_gating", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk_gating.cu",
             "replaces": "src/repro/kernels/topk_gating.py:16",
             "launches": moe_launches["topk_gating"], "max_abs_err": topk_err,
             "ms": rows["topk"]["ms"], "plain_ms": rows["topk"]["plain_ms"],
             "bound_ms": rows["topk"]["bound_ms"], "bound_by": rows["topk"]["bound_by"],
             "library_ms": None}]


# K6's timed decode shapes: (name, B, S_max, H, Hkv, d, dtype, positions'
# range).  dsmoe16b's chat cell holds 32 slots of 2560 positions about a
# third full (kv_used_share.chat 33.7 %), its longdoc cell 24 slots of 4096
# past 2048-3968-token prompts; each row's position is drawn from the range.
DECODE_TIMED = [
    ("chat", 32, 2560, 16, 16, 128, "bfloat16", (64, 1724)),
    ("longdoc", 24, 4096, 16, 16, 128, "bfloat16", (2048, 4000)),
]


def decode_bound(b, h, hkv, d, dtype, positions, window=0):
    """(bound_ms, bound_by) of one K6 call: the K and V rows of the positions
    attended before each row's own read once, its new K and V rows written,
    q, k_new and v_new read and o written; 4 flops a (query head, key)
    element pair, at the dtype's CUDA-core (fp32) or tensor-core peak."""
    elt = 2 if dtype == "bfloat16" else 4
    held = sum(p - (max(0, p - window + 1) if window else 0) for p in positions)
    nbytes = elt * (2 * hkv * d * held + 2 * b * hkv * d + b * (2 * h + 2 * hkv) * d)
    flops = 4 * h * d * (held + b)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["bfloat16" if dtype == "bfloat16" else "float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_case(b, s_max, h, hkv, d, dt, seed):
    """(q, k_new, v_new, [cache_k, cache_v]) of one decode call, normal draws."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dt)
    k_new, v_new = (torch.randn((b, 1, hkv, d), generator=g, device="cuda").to(dt)
                    for _ in range(2))
    caches = [torch.randn((b, s_max, hkv, d), generator=g, device="cuda").to(dt)
              for _ in range(2)]
    return q, k_new, v_new, caches


def check_decode(case, pos, theta, window=0):
    """K6 and its plain version on copies of ``case``'s caches: the caches
    must be bitwise equal after both, and K6's output within one rounding
    to q's dtype of fp64 attention over them (|err| <= 1e-4 + u·|ref|, u
    2**-8 in bf16, 2e-6 in fp32: the card tests' bound).  Returns (K6's
    output, the plain version's, the caches K6 wrote, max |err|, the largest
    share of the bound used)."""
    import torch

    from repro_torch.kernels import decode_attention as k6
    from repro_torch.models.attention import decode_attention_plain
    from repro_torch.models.layers import apply_rope

    q, k_new, v_new, caches = case
    kc, pc = [c.clone() for c in caches], [c.clone() for c in caches]
    got = k6.decode_attention(q, k_new, v_new, *kc, pos, theta, window=window)
    want = decode_attention_plain(q, k_new, v_new, *pc, pos, theta, window=window)
    if not (torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])):
        raise AssertionError(f"decode_attention wrote other caches than its plain version "
                             f"at {tuple(caches[0].shape)}, pos {pos}")
    del pc
    b, _, h, d = q.shape
    s_max, hkv = kc[0].shape[1], kc[0].shape[2]
    posb = torch.as_tensor(pos, device=q.device).reshape(-1, 1).expand(b, 1).long()
    qr = apply_rope(q, posb, theta).double()[:, 0].reshape(b, hkv, h // hkv, d)
    idx = torch.arange(s_max, device=q.device)[None, :]
    mask = idx <= posb
    if window:
        mask &= (posb - idx) < window
    lg = torch.einsum("bkrd,bskd->bkrs", qr, kc[0].double()) * d ** -0.5
    lg = torch.where(mask[:, None, None, :], lg, -torch.inf)
    ref = torch.einsum("bkrs,bskd->bkrd", torch.softmax(lg, dim=-1),
                       kc[1].double()).reshape(b, 1, h, d)
    err = (got.double() - ref).abs()
    bound = 1e-4 + (2 ** -8 if q.dtype == torch.bfloat16 else 2e-6) * ref.abs()
    share = (err / bound).max().item()
    if share > 1:
        raise AssertionError(f"decode_attention at {tuple(caches[0].shape)}, pos {pos}: "
                             f"|err| {err.max().item()} over its fp64 bound")
    return got, want, kc, err.max().item(), share


def phase_decode_checks():
    """K6 at the main paths' own decode shapes, checked and not timed:
    llama2-7b's and deepseek-moe-16b's heads, in bf16 (``phase_main_path``,
    ``phase_moe_main``) and fp32 (``launch.serve``'s fp32), Engine's aligned
    decode at every position it decodes (one int, B = ENGINE_BATCH, S_max =
    ENGINE_PROMPT + ENGINE_NEW + 1) and SlotServer's per-slot positions (2
    slots of 128, pairs over the cache and its edges), each by
    ``check_decode``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    engine_len = ENGINE_PROMPT + ENGINE_NEW + 1
    rng = np.random.default_rng(11)
    slot_pos = [(0, 127), (127, 0), (64, 17)] + rng.integers(0, 128, (8, 2)).tolist()
    for arch in (ARCH, MOE_ARCH):
        cfg = get_arch(arch)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            errs, shares = [], []
            for p in range(ENGINE_PROMPT, ENGINE_PROMPT + ENGINE_NEW - 1):
                case = decode_case(ENGINE_BATCH, engine_len, h, hkv, d, dt, seed=p)
                errs.append(check_decode(case, p, cfg.rope_theta)[3:])
            for i, pair in enumerate(slot_pos):
                case = decode_case(2, 128, h, hkv, d, dt, seed=1000 + i)
                pos = torch.tensor(pair, dtype=torch.int32, device="cuda")
                shares.append(check_decode(case, pos, cfg.rope_theta)[3:])
            emit("decode_check", arch=arch, dtype=dtype, heads=[h, hkv, d],
                 engine=dict(shape=[ENGINE_BATCH, engine_len], calls=len(errs),
                             max_abs_err=max(e for e, _ in errs),
                             max_bound_share=max(s for _, s in errs)),
                 slot=dict(shape=[2, 128], calls=len(shares),
                           max_abs_err=max(e for e, _ in shares),
                           max_bound_share=max(s for _, s in shares)))


def phase_decode_times(launches=None):
    """``phase_decode_checks``, then K6 at DECODE_TIMED: held to its plain
    version and to fp64 there by ``check_decode``, then timed as a loop, one launch, the profiler's
    device time and inside a CUDA graph, beside its bound, the plain version
    and SDPA over the cache it wrote (the library yardstick: attention
    alone, given the roped q; the port never calls it), and the wrapper's
    host time per call."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k6
    from repro_torch.models.attention import decode_attention_plain
    from repro_torch.models.layers import apply_rope

    phase_decode_checks()
    rows = {}
    for name, b, s_max, h, hkv, d, dtype, (lo, hi) in DECODE_TIMED:
        dt = getattr(torch, dtype)
        q, k_new, v_new, caches = case = decode_case(b, s_max, h, hkv, d, dt, seed=7)
        positions = np.random.default_rng(7).integers(lo, hi, b).tolist()
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        theta = 10000.0
        _, want, caches, err, share = check_decode(case, pos, theta)
        del case
        posb = pos.long()[:, None]
        q_rot = apply_rope(q, posb, theta).transpose(1, 2)
        k_view, v_view = (c.transpose(1, 2) for c in caches)
        mask = (torch.arange(s_max, device="cuda")[None, :] <= posb)[:, None, None, :]

        def kernel():
            return k6.decode_attention(q, k_new, v_new, *caches, pos, theta)

        def plain():
            return decode_attention_plain(q, k_new, v_new, *caches, pos, theta)

        def sdpa():
            return F.scaled_dot_product_attention(q_rot, k_view, v_view, attn_mask=mask,
                                                  enable_gqa=h != hkv)
        lib_err = (sdpa().transpose(1, 2).float() - want.float()).abs().max().item()
        if lib_err > 2e-2:
            raise AssertionError(f"SDPA at {name} is {lib_err} off the plain version")
        bound_ms, bound_by = decode_bound(b, h, hkv, d, dtype, positions)
        splits, split_len = k6.schedule(s_max, b * hkv)
        rows[name] = dict(ms=cuda_ms(kernel, 100), plain_ms=cuda_ms(plain, 20),
                          library_ms=cuda_ms(sdpa, 50), bound_ms=bound_ms, bound_by=bound_by,
                          kernel_single_ms=single_ms(kernel), kernel_graph_ms=graph_ms(kernel),
                          host_enqueue_us=enqueue_us(kernel), max_abs_err=err,
                          max_bound_share=share, library_max_abs_err=lib_err,
                          **device_times(kernel=kernel, plain=plain, sdpa=sdpa))
        # the graph's time: late in a long process the profiler drops the
        # port's launches (PERF.md section 7) and reads 0
        rows[name]["bound_share_of_graph"] = bound_ms / rows[name]["kernel_graph_ms"]
        emit("time", kernel="decode_attention", case=name, shape=[b, s_max, h, hkv, d],
             dtype=dtype, positions_mean=float(np.mean(positions)), grid=[splits, hkv, b],
             split_len=split_len, smem_bytes=k6.smem_bytes(dt, d, h // hkv), **rows[name])
    chat = rows["chat"]
    return [{"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
             "replaces": "none (the reference's decode attention is plain jnp)",
             "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
             "ms": chat["ms"], "plain_ms": chat["plain_ms"], "bound_ms": chat["bound_ms"],
             "bound_by": chat["bound_by"], "library_ms": chat["library_ms"]}]


# fp32 K3 calls that the main paths make: launch.serve's defaults
# (tinyllama-1.1b, batch 4, prompt 16), its llama2-7b prefill at prompt 64,
# a long prompt, and train_sharded's prefill: (name, B, S, H, Hkv, d, window)
FP32_K3_TIMED = [
    ("serve_default_fp32", 4, 16, 32, 4, 64, 0),
    ("engine_prefill_fp32", 4, 64, 32, 32, 128, 0),
    ("long_prompt_fp32", 1, 2048, 32, 32, 128, 0),
    ("sharded_prefill_fp32", 4, 512, 32, 32, 128, 0),
]
# fp32 K4 calls at mamba2-780m's widths (H 48, P 64, N 128, chunk 256):
# serve_fp32's prefill, a 600-token prompt (3 chunks), sharded_ssm's prefill
FP32_K4_TIMED = [("engine_prefill_fp32", 4, 64), ("prompt_s600_fp32", 1, 600),
                 ("sharded_prefill_fp32", 4, 512)]


def phase_fp32_times(errs=None, launches=None):
    """Times of K3 and K4 in fp32 at FP32_K3_TIMED and FP32_K4_TIMED, beside
    their plain versions and their bounds at the fp32 tensor-core rate
    (``float32_tc``) and, for comparison, at the CUDA cores' 67 TFLOP/s.
    K3: a loop of launches, one launch, the profiler's device time, and
    SDPA in fp32, held first against the plain version at TOL["float32"]
    (where it misses, its error is recorded and it is no yardstick); K4: a
    loop, one launch and the time inside a CUDA graph.  Returns the two
    kernels' entries of the ``kernels`` line (fp32 main-path errors and
    launches from ``errs``/``launches`` where given)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4

    rows = {}
    for name, b, s, h, hkv, d, window in FP32_K3_TIMED:
        q, k, v = qkv(b, s, h, hkv, d, "float32", seed=7)

        def kernel():
            return fa.flash_attention(q, k, v, window=window)

        def plain():
            return fa.flash_attention_plain(q, k, v, window=window)
        library = sdpa(q, k, v, window)
        want = plain()
        err = (kernel() - want).abs().max().item()
        lib_err = (library().transpose(1, 2) - want).abs().max().item()
        same = lib_err <= TOL["float32"]
        iters = 200 if s <= 256 else 20
        bound_ms, bound_by = flash_bound(b, s, h, hkv, d, window, "float32")
        rows[name] = dict(
            ms=cuda_ms(kernel, iters), kernel_single_ms=single_ms(kernel),
            plain_ms=cuda_ms(plain, iters), library_ms=cuda_ms(library, iters) if same else None,
            library_max_abs_err=lib_err, library_same_function=same,
            bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_cuda_cores=flash_bound(b, s, h, hkv, d, window, "float32",
                                            peak=PEAK_FLOPS["float32"])[0],
            max_abs_err=err,
            **device_times(kernel=kernel, plain=plain,
                           **({"library": library} if same else {})))
        emit("time", kernel="flash_attention", case=name, shape=[b, s, h, hkv, d],
             dtype="float32", window=window, tiles=fa.tiles(d, torch.float32),
             **rows[name], **({} if same else {"library": "not the same function"}))
    cfg = get_arch(SSM_ARCH)
    h, p, n, chunk = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    for name, b, s in FP32_K4_TIMED:
        args = ssd_inputs(b, s, h, p, n, "float32", seed=7)
        q = k4.clamp_chunk(chunk, s)

        def kernel():
            return k4.ssd_scan(*args, chunk=chunk)

        def plain():
            return k4.ssd_scan_plain(*args, chunk=q)
        (y, st), (wy, wst) = kernel(), plain()
        err = max((y - wy).abs().max().item(), (st - wst).abs().max().item())
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, q, "float32")
        rows[f"k4_{name}"] = dict(
            ms=cuda_ms(kernel, 50), kernel_single_ms=single_ms(kernel),
            kernel_graph_ms=graph_ms(kernel), plain_ms=cuda_ms(plain, 20),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_cuda_cores=ssd_bound(b, s, h, p, n, q, "float32",
                                          peak=PEAK_FLOPS["float32"])[0],
            max_abs_err=err, **device_times(kernel=kernel, plain=plain))
        emit("time", kernel="ssd_scan", case=name, shape=[b, s, h, p, n], chunk=q,
             dtype="float32", grid=k4.schedule(b, s, h, p, n, q)["grids"],
             smem_bytes=k4.smem_bytes(p, n, q, torch.float32), **rows[f"k4_{name}"])
    errs, launches = errs or {}, launches or {}
    k3, k4m = rows["engine_prefill_fp32"], rows["k4_engine_prefill_fp32"]
    return [{"name": "flash_attention_fp32", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:31",
             "launches": launches.get("flash_attention_fp32"),
             "max_abs_err": errs.get("flash_attention_fp32", k3["max_abs_err"]),
             "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
             "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
            {"name": "ssd_scan_fp32", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:26",
             "launches": launches.get("ssd_scan_fp32"),
             "max_abs_err": errs.get("ssd_scan_fp32", k4m["max_abs_err"]),
             "ms": k4m["ms"], "plain_ms": k4m["plain_ms"], "bound_ms": k4m["bound_ms"],
             "bound_by": k4m["bound_by"], "library_ms": None}]


# launch.serve at its defaults (batch 4, float32, --attn-impl flash,
# --ssd-impl cuda) but these: the fp32 paths of K3 and K4 as a user meets them
SERVE_FP32_ARGV = ["--prompt-len", "64", "--gen", "8"]
SERVE_FP32_ARCHS = (ARCH, SSM_ARCH)
SERVE_FP32_RTOL = 1e-5        # prefill logits against the plain paths, over max |logit|
# ... unless the same model with K3 replaced by its plain version in
# float64 (rounded to fp32) is already farther from the plain paths: over
# 32 fp32 layers of random weights any two attentions that are not bitwise
# equal end about 1.2e-5 of max |logit| apart (float64 attention 1.26e-5,
# the first port's fp32 FMA kernel 1.33e-5; PERF.md §6, PR 23), so there
# the kernel path may be no farther from the plain paths than exact
# attention in the kernel's place is.  A model without attention (K4
# only) is held to SERVE_FP32_RTOL alone.


def phase_serve_fp32(seed):
    """``repro_torch.launch.serve.main`` at its defaults but ``--arch``,
    ``--prompt-len 64`` and ``--gen 8``: llama2-7b at full width and depth
    (32 layers, fp32, about 27 GB of weights), then mamba2-780m (48 layers).
    K3's and K4's counts are set to 0 just before ``main`` and read just
    after: one prefill must launch K3 once per attention layer and K4 once
    per Mamba layer.  The first K3 and the first K4 call, their operands
    and outputs recorded, are held against their plain versions
    (TOL["float32"], SSD_TOL); the prefill logits of the same weights on
    the plain paths (``attn_impl="xla"``, ``ssd_impl="jnp"``) within
    SERVE_FP32_RTOL of max |logit|, or, with attention, no farther from
    them than the same weights with K3 replaced by its plain version in
    float64 (``exact_vs_plain_paths``: the floor of fp32 rounding that the
    plain paths themselves bring); prefill ms, decode ms per token (CUDA
    events, as ``serve_times``) and peak memory.  Returns the launches."""
    import numpy as np
    import torch

    import repro_torch.models as models_pkg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch import serve
    from repro_torch.models import attention, mamba2
    from repro_torch.serve.engine import pad_caches

    out = {}
    for arch in SERVE_FP32_ARCHS:
        t_phase = time.perf_counter()
        made, first = [], {}
        real_model, real_k3, real_k4 = models_pkg.Model, attention.flash_attention, mamba2.ssd_scan

        def capture(*args, **kw):
            made.append(real_model(*args, **kw))
            return made[-1]

        def recording(key, fn):
            def call(*args, **kw):
                res = fn(*args, **kw)
                if key not in first:
                    outs = res if isinstance(res, tuple) else (res,)
                    first[key] = ([a.clone() for a in args], kw, [o.clone() for o in outs])
                return res
            return call
        models_pkg.Model = capture
        attention.flash_attention = recording("k3", real_k3)
        mamba2.ssd_scan = recording("k4", real_k4)
        try:
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention.launches = k4.ssd_scan.launches = 0
            t0 = time.perf_counter()
            res = serve.main(["--arch", arch, *SERVE_FP32_ARGV])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = {"flash_attention": fa.flash_attention.launches,
                        "ssd_scan": k4.ssd_scan.launches}
            # ---- end of the counted run
        finally:
            models_pkg.Model, attention.flash_attention, mamba2.ssd_scan = (
                real_model, real_k3, real_k4)
        peak = torch.cuda.max_memory_allocated()
        model, = made
        cfg = model.cfg
        specs = cfg.layer_specs()
        want = {"flash_attention": sum(sp.mixer in ("attn", "attn_local") for sp in specs),
                "ssd_scan": sum(sp.mixer == "mamba" for sp in specs)}

        kernel_errs = {}
        if "k3" in first:
            (q, k, v), kw, (o,) = first.pop("k3")
            o_plain = fa.flash_attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])
            kernel_errs["k3"] = ((o - o_plain).abs().max().item(), bool(torch.allclose(
                o, o_plain, atol=TOL["float32"], rtol=TOL["float32"])), list(q.shape))
            del q, k, v, o, o_plain
        if "k4" in first:
            args, kw, (y, st) = first.pop("k4")
            y_plain, st_plain = k4.ssd_scan_plain(
                *args, chunk=k4.clamp_chunk(kw["chunk"], args[0].shape[1]))
            kernel_errs["k4"] = (max((y - y_plain).abs().max().item(),
                                     (st - st_plain).abs().max().item()),
                                 bool(torch.allclose(y, y_plain, atol=SSD_TOL, rtol=SSD_TOL)
                                      and torch.allclose(st, st_plain, atol=SSD_TOL,
                                                         rtol=SSD_TOL)),
                                 list(args[0].shape))
            del args, y, st, y_plain, st_plain

        # the same prompt as main's, on the plain paths of the same weights,
        # and (with attention) with K3's plain version in float64 in its place
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        plain = same_weights(model, dataclasses.replace(model.flags, attn_impl="xla",
                                                        ssd_impl="jnp"))

        def exact_k3(q, k, v, **kw):
            return fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                            causal=kw["causal"], window=kw["window"]).float()
        floors = {}
        with torch.inference_mode():
            lk, _ = model.prefill({"tokens": tokens})
            lp, _ = plain.prefill({"tokens": tokens})
            if want["flash_attention"]:
                attention.flash_attention = exact_k3
                try:
                    le, _ = model.prefill({"tokens": tokens})
                finally:
                    attention.flash_attention = real_k3
                floors = {"exact_vs_plain_paths": logits_gap(le, lp),
                          "kernel_vs_exact": logits_gap(lk, le)}
                del le
        gap = logits_gap(lk, lp)
        allowed = max([SERVE_FP32_RTOL * gap["max_abs_logit"]]
                      + [f["max_abs_diff"] for k, f in floors.items() if k.startswith("exact")])
        del plain, lk, lp
        with torch.inference_mode():
            prefill_ms = cuda_ms(lambda: model.prefill({"tokens": tokens}), iters=5, warmup=1)
            _, caches = model.prefill({"tokens": tokens})
            caches = pad_caches(caches, 64, 64 + ENGINE_NEW + 1)
            tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
            steps = iter(range(64, 64 + ENGINE_NEW))
            decode_ms = cuda_ms(lambda: model.decode_step(tok, caches, next(steps)),
                                iters=ENGINE_NEW - 4, warmup=2)
        del caches
        ok = (launches == want and all(e[1] for e in kernel_errs.values())
              and len(kernel_errs) == sum(n > 0 for n in want.values()) and gap["finite"]
              and gap["max_abs_diff"] <= allowed and res.tokens.shape == (4, 8))
        emit("serve_fp32", arch=cfg.name, argv=["--arch", arch, *SERVE_FP32_ARGV],
             n_layers=cfg.n_layers, dtype=str(model.flags.dtype), launches=launches,
             expected_launches=want,
             **{f"{key}_first_call": {"shape": e[2], "max_abs_err_vs_plain": e[0], "ok": e[1]}
                for key, e in kernel_errs.items()},
             kernel_vs_plain_paths=gap, **floors, rtol=SERVE_FP32_RTOL,
             allowed_max_abs_diff=allowed, main_seconds=main_s,
             prefill_ms=prefill_ms, decode_ms_per_token=decode_ms, max_memory_allocated=peak,
             phase_seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line(), ok=ok)
        out[arch] = launches if ok else None
        del model, made, res
        torch.cuda.empty_cache()
    failed = [arch for arch, launches in out.items() if launches is None]
    if failed:
        raise AssertionError(f"serve_fp32 {failed}: launches, the first kernel calls or the "
                             "logits against the plain paths are off")
    return out


# ---------------------------------------------------------------------------
# The frontends (K3 under the vision and audio archs) and the trainer (K5
# forward and backward)
# ---------------------------------------------------------------------------

# The paper's LLaVA traffic: 576 image tokens ahead of 64 text tokens, batch
# 4, 32 new tokens; musicgen-medium's prefill is 640 frames.
FRONTEND_ARCHS = ("llava-v1.5-7b", "internvl2-2b", "musicgen-medium")
FRONTEND_TEXT, FRONTEND_PROMPT = 64, 640


def frontend_batch(cfg, seed):
    """A vision batch (F image embeddings and FRONTEND_TEXT tokens) or an
    audio batch (FRONTEND_PROMPT frame embeddings), numpy, as the serve CLI
    makes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = ENGINE_BATCH
    if cfg.frontend == "vision":
        return {"image_embeds": rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model),
                                                    dtype=np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, FRONTEND_TEXT)).astype(np.int32)}
    return {"frame_embeds": rng.standard_normal((b, FRONTEND_PROMPT, cfg.d_model),
                                                dtype=np.float32)}


def frontend_generate(model, batch):
    """Greedy generation of ENGINE_NEW tokens: ``Engine.generate`` for a
    vision batch; for an audio batch, which the Engine refuses (it has no
    tokens), the prefill and ENGINE_NEW - 1 ``decode_step``s on the argmax
    tokens, the same loop by hand.  Returns (tokens, prompt length)."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine
    from repro_torch.serve.engine import pad_caches

    if model.cfg.frontend == "vision":
        res = Engine(model, max_len=FRONTEND_PROMPT + ENGINE_NEW + 1).generate(batch, ENGINE_NEW)
        return res.tokens, res.n_prompt
    with torch.inference_mode():
        logits, caches = model.prefill(batch)
        caches = pad_caches(caches, FRONTEND_PROMPT, FRONTEND_PROMPT + ENGINE_NEW + 1)
        tok = torch.argmax(logits, dim=-1)[:, None]
        toks = [tok[:, 0]]
        for pos in range(FRONTEND_PROMPT, FRONTEND_PROMPT + ENGINE_NEW - 1):
            logits, caches = model.decode_step(tok, caches, pos)
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok[:, 0])
    return torch.stack(toks, dim=1).to(torch.int32).cpu().numpy(), FRONTEND_PROMPT


def phase_frontends_main(seed):
    """llava-v1.5-7b, internvl2-2b and musicgen-medium at full width and
    depth in bf16 with flash attention and random weights: the vision archs
    through ``Engine.generate`` (4 x (576 + 64) -> 32 tokens), the audio
    arch through its prefill of 640 frames and 31 ``decode_step``s.  K3's
    launches must equal the layers (one prefill each).  Drift gate: the
    flash path and the plain grouped path, each against an fp32 copy on
    the plain path, at full depth.  Prefill ms, decode ms per token and
    peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import BuildFlags, Model
    from repro_torch.serve.engine import pad_caches

    t_phase = time.perf_counter()
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    launches = {}
    for i, name in enumerate(FRONTEND_ARCHS):
        cfg = get_arch(name)
        t0 = time.perf_counter()
        model = Model(cfg, flags, device="cuda", seed=seed + i)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        emit("init", arch=name, n_layers=cfg.n_layers, d_model=cfg.d_model, d_head=cfg.d_head,
             frontend=cfg.frontend, params=n_params, seconds=time.perf_counter() - t0)
        batch = frontend_batch(cfg, seed + i)
        n_attn = sum(1 for s in cfg.layer_specs() if s.mixer in ("attn", "attn_local"))

        # ---- the path, with every kernel's launch count set to 0 just before
        torch.cuda.reset_peak_memory_stats()
        for kern in (k4.ssd_scan, k5.topk_gating, fa.flash_attention):
            kern.launches = 0
        t0 = time.perf_counter()
        tokens, prompt = frontend_generate(model, batch)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        got = {"flash_attention": fa.flash_attention.launches,
               "ssd_scan": k4.ssd_scan.launches, "topk_gating": k5.topk_gating.launches}
        # ---- end of the path
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_attention": n_attn, "ssd_scan": 0, "topk_gating": 0}
        emit("frontends_main", arch=name, prompt=prompt, batch=ENGINE_BATCH, n_gen=ENGINE_NEW,
             generate_seconds=gen_s, generate_tokens_per_s=ENGINE_BATCH * ENGINE_NEW / gen_s,
             launches=got, expected=want, max_memory_allocated=peak)
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want} (one prefill)")
        if tokens.shape != (ENGINE_BATCH, ENGINE_NEW) or not (
                (tokens >= 0).all() and (tokens < cfg.vocab_size).all()):
            raise AssertionError(f"{name}: generated tokens wrong: shape {tokens.shape}")
        launches[name] = got["flash_attention"]

        # ---- times: prefill, decode per token (CUDA events), after the counted run
        with torch.inference_mode():
            prefill_ms = cuda_ms(lambda: model.prefill(batch), iters=3, warmup=1)
            _, caches = model.prefill(batch)
            caches = pad_caches(caches, prompt, prompt + ENGINE_NEW + 1)
            tok = torch.zeros((ENGINE_BATCH, 1), dtype=torch.long, device="cuda")
            steps = iter(range(prompt, prompt + ENGINE_NEW))
            decode_ms = cuda_ms(lambda: model.decode_step(tok, caches, next(steps)),
                                iters=ENGINE_NEW - 4, warmup=2)
            del caches
        emit("serve", path="frontends_main", arch=name, batch=ENGINE_BATCH, prompt=prompt,
             n_gen=ENGINE_NEW, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
             max_memory_allocated=peak, nvidia_smi=nvidia_smi_line())

        # ---- drift gate against an fp32 twin on the plain grouped path, at
        # full depth: the largest, llava's, takes 40.5 GB with the bf16 model
        plain = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
        ref = same_weights(model, dataclasses.replace(flags, attn_impl="xla", dtype="float32"),
                           cast=torch.float32)
        with torch.inference_mode():
            lk, _ = model.prefill(batch)
            lp, _ = plain.prefill(batch)
            lr, _ = ref.prefill(batch)
        drift_gate(lk, lp, lr, f"frontends_main {name}", names=("flash", "xla"),
                   n_layers=cfg.n_layers, prompt=prompt)
        del model, plain, ref, lk, lp, lr
        torch.cuda.empty_cache()
    emit("frontends_main", phase_seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi_line())
    return launches


# The trainer: (a) the launcher's default arch at full width and depth, fp32,
# crashed and resumed; (b) deepseek-moe-16b at full width with its depth cut
# 28 -> 4 (the dense layer and 3 MoE layers: AdamW's fp32 state for 28
# layers would take about 262 GB), so K5 runs forward and in the remat
# recompute.
TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--batch", "8", "--seq", "128", "--steps", "20",
              "--save-every", "5", "--log-every", "1", "--keep", "2"]
TRAIN_FAULT_AT, TRAIN_RESUMED_FROM = 12, 10
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 10
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 512
TRAIN_LOSS_RTOL = 1e-5        # step 1's loss, K5 against its plain version (fp32)
ROUTER_GRAD_RTOL = 1e-4       # the routers' gradients, over max |g|


def train_losses(stdout):
    """{step: loss} from ``launch.train``'s log lines (the ``float.hex`` field)."""
    import re

    return {int(m.group(1)): float.fromhex(m.group(2))
            for m in re.finditer(r"\[train\] step +(\d+) loss \S+ \((\S+)\)", stdout)}


def run_train(argv, label, want_rc=0):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                         env=port_env(), cwd=REPO, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if out.returncode != want_rc:
        raise AssertionError(f"train {label}: exit {out.returncode}, want {want_rc}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, secs


def phase_train_cli(tmp):
    """(a) ``python -m repro_torch.launch.train`` (tinyllama-1.1b, the
    launcher's default arch, full width and depth, fp32, batch 8, seq 128,
    20 steps, a checkpoint every 5): crashed by ``--fault-at 12`` (exit 42,
    checkpoints at 5 and 10 on disk), resumed in a fresh process (it must
    print ``resumed from step 10``), and run once uninterrupted; the resumed
    run's losses must equal the uninterrupted run's bit for bit."""
    import re
    import shutil

    ck = os.path.join(tmp, "train_ck")
    free = shutil.disk_usage(tmp).free
    crash_out, crash_s = run_train(TRAIN_ARGV + ["--checkpoint-dir", ck,
                                                 "--fault-at", str(TRAIN_FAULT_AT)],
                                   "crash", want_rc=CRASH_EXIT)
    resume_out, resume_s = run_train(TRAIN_ARGV + ["--checkpoint-dir", ck], "resume")
    straight_out, straight_s = run_train(TRAIN_ARGV, "uninterrupted")
    crashed, resumed, straight = (train_losses(o) for o in (crash_out, resume_out,
                                                             straight_out))
    marker = f"[train] resumed from step {TRAIN_RESUMED_FROM}"
    ms_step = [float(x) for x in re.findall(r"\((\d+) ms/step\)", straight_out)][-1:]
    emit("train_main", part="a", argv=TRAIN_ARGV, fault_at=TRAIN_FAULT_AT,
         crash_seconds=crash_s, resume_seconds=resume_s, uninterrupted_seconds=straight_s,
         resumed_marker=marker in resume_out, crashed_steps=sorted(crashed),
         resumed_steps=sorted(resumed),
         losses_first_last=[straight.get(1), straight.get(20)],
         uninterrupted_ms_per_step=ms_step,
         tokens_per_s=[8 * 128 / (m / 1e3) for m in ms_step],
         disk_free_bytes=free, nvidia_smi=nvidia_smi_line())
    if marker not in resume_out:
        raise AssertionError(f"train: the rerun did not resume from step "
                             f"{TRAIN_RESUMED_FROM}:\n{resume_out[-2000:]}")
    if sorted(straight) != list(range(1, 21)) or sorted(resumed) != list(range(11, 21)):
        raise AssertionError(f"train: logged steps {sorted(straight)} / {sorted(resumed)}")
    differ = [s for s in resumed if resumed[s] != straight[s]]
    same_before = all(crashed[s] == straight[s] for s in crashed)
    if differ or not same_before:
        raise AssertionError(f"train: resumed losses differ from the uninterrupted run's at "
                             f"steps {differ} (before the crash equal: {same_before})")
    if not straight[20] < straight[1]:
        raise AssertionError(f"train: the loss did not fall: {straight[1]} -> {straight[20]}")


def phase_train_moe(seed):
    """(b) deepseek-moe-16b at full width, depth cut to 4 layers (the dense
    layer and 3 MoE layers), fp32, remat selective, AdamW as the launcher
    builds it, batch 4 x 512: step 1's loss and the routers' gradients with
    K5 against the same with K5's plain version; then 10 steps, K5's
    launches set to 0 just before and read just after, which must equal
    the MoE layers x (forward + recompute) x steps; the loss must fall."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import (adamw, cosine_schedule, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    n_moe = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
    flags = BuildFlags(dtype="float32", remat="selective", sp=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, flags, device="cuda", seed=seed)
    opt = adamw(cosine_schedule(1e-3, max(MOE_TRAIN_STEPS // 20, 1), MOE_TRAIN_STEPS))
    state = init_train_state(model, opt)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", arch=cfg.name, n_layers=MOE_TRAIN_LAYERS, cut_from=get_arch(MOE_ARCH).n_layers,
         params=n_params, seconds=time.perf_counter() - t0)
    data = SyntheticLM(cfg, DataConfig(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed))

    # ---- K5 against its plain version under autograd, on step 1's batch
    batch = to_device(data.batch(0), "cuda")
    routers = [p for n, p in model.named_parameters() if n.endswith("router")]
    out = {}
    for label, gate in (("kernel", moe_mod.topk_gating), ("plain", k5.topk_gating_plain)):
        moe_mod.topk_gating = gate
        try:
            loss, _ = model.loss_fn(batch)
            out[label] = (loss.detach(), torch.autograd.grad(loss, routers))
        finally:
            moe_mod.topk_gating = k5.topk_gating
    loss_err = abs(out["kernel"][0].item() - out["plain"][0].item())
    g_scale = max(g.abs().max().item() for g in out["plain"][1])
    g_err = max((a - b).abs().max().item() for a, b in zip(out["kernel"][1], out["plain"][1]))
    ok = (loss_err <= TRAIN_LOSS_RTOL * abs(out["plain"][0].item())
          and g_err <= ROUTER_GRAD_RTOL * g_scale and g_scale > 0)
    emit("train_moe_parity", loss_kernel=out["kernel"][0].item(),
         loss_plain=out["plain"][0].item(), loss_abs_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         router_grad_max_abs_err=g_err, router_grad_max_abs=g_scale,
         router_grad_rtol=ROUTER_GRAD_RTOL, ok=ok)
    if not ok:
        raise AssertionError("K5 in the MoE trainer disagrees with its plain version")
    del out, loss

    # ---- the training run, K5's (and K3's) counts set to 0 just before
    step_fn = make_train_step(model, opt)
    batches = [to_device(data.batch(i), "cuda") for i in range(MOE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    k5.topk_gating.launches = fa.flash_attention.launches = 0
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, met = step_fn(state, b)
        losses.append(met["loss"].item())        # syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"topk_gating": k5.topk_gating.launches,
                "flash_attention": fa.flash_attention.launches}
    # ---- end of the run
    peak = torch.cuda.max_memory_allocated()
    want = {"topk_gating": n_moe * 2 * MOE_TRAIN_STEPS, "flash_attention": 0}
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    emit("train_main", part="b", arch=cfg.name, n_layers=MOE_TRAIN_LAYERS, moe_layers=n_moe,
         batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, remat="selective", steps=MOE_TRAIN_STEPS,
         losses=losses, step_ms=step_ms, median_step_ms_after_first=steady,
         tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (steady / 1e3),
         launches=launches, expected=want, max_memory_allocated=peak,
         params=n_params, nvidia_smi=nvidia_smi_line())
    if launches != want:
        raise AssertionError(f"MoE trainer launches {launches}, expected {want}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MoE trainer: the loss did not fall: {losses}")
    del model, state, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_main(tmp):
    t0 = time.perf_counter()
    phase_train_cli(tmp)
    launches = phase_train_moe(SEED)
    emit("train_main", phase_seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    return launches


# The paper's LLaVA sweep (Fig. 4): the explore command with --workload
# llava-v1.5-7b; its prompt holds the 576 image tokens and 64 text tokens
# (at the default --prompt-len 64 neither package can build it).
LLAVA_EXPLORE = ["--workload", "llava-v1.5-7b", "--shape", "generate", "--algorithm", "bayesopt",
                 "--seed", "0", "--prompt-len", str(FRONTEND_PROMPT)]
LLAVA_SAMPLES = 32


def phase_explore_llava(tmp):
    """``launch.explore --workload llava-v1.5-7b --prompt-len 640 --gp cuda``,
    32 samples, 2 clients (each build counts llava at full width on meta,
    its 576 image embeddings through the frontend projection); then at one
    client ``--gp cuda`` (every K1a/K1b call recorded and held against its
    plain version) against ``--gp incremental`` on one cache: identical
    knob and metric columns per config_id."""
    t0 = time.perf_counter()
    cache = os.path.join(tmp, "llava_cache")
    argv = LLAVA_EXPLORE + ["--gp", "cuda", "--clients", "2", "--samples", str(LLAVA_SAMPLES),
                            "--cache-dir", cache, "--out", os.path.join(tmp, "llava_main.csv")]
    res, launches, by_form, busy = device_busy(counted_explore, argv)
    check_sweep(res, LLAVA_SAMPLES, "explore_llava")
    if min(launches["gp_w"], launches["gp_g"]) == 0:
        raise AssertionError(f"explore_llava: K1a/K1b were not launched: {launches}")
    emit("explore_llava", argv=argv, launches=launches, launches_by_form=by_form,
         **explore_summary(res, busy, 2))
    cols = {}
    for gp in ("cuda", "incremental"):
        out = os.path.join(tmp, f"llava_{gp}.csv")
        calls = [] if gp == "cuda" else None
        res, launches, _ = counted_explore(
            LLAVA_EXPLORE + ["--gp", gp, "--clients", "1", "--samples", str(LLAVA_SAMPLES),
                             "--cache-dir", cache, "--out", out], record=calls)
        check_sweep(res, LLAVA_SAMPLES, f"explore_llava {gp}")
        cols[gp] = sweep_columns(out)
        if calls is not None:
            check_recorded(calls, "explore_llava")
        emit("explore_llava", gp=gp, clients=1, launches=launches, builds=res.timings["builds"],
             wall_seconds=res.timings["wall_s"])
    same = sum(cols["cuda"].get(i) == row for i, row in cols["incremental"].items())
    emit("explore_llava", configs=len(cols["incremental"]), identical_rows=same,
         phase_seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    if cols["cuda"] != cols["incremental"]:
        raise AssertionError(f"explore_llava: --gp cuda and --gp incremental differ ({same} of "
                             f"{len(cols['incremental'])} rows identical)")


# The paper's sweep on a train shape (slice 7b): the explore command with
# --shape train_4k, whose builds count a whole train step of llama2-7b at full
# width on meta (about 5 s each on a CPU core); 14 samples take BayesOpt
# past its 12 random picks, so the GP kernels run.  The EHVI sweep reuses the
# ParEGO sweep's builds of the same random picks (--cache-dir).
TRAIN_EXPLORE = ["--workload", "llama2-7b", "--shape", "train_4k", "--algorithm", "bayesopt",
                 "--seed", "0"]
TRAIN_EXPLORE_SAMPLES = 14


def phase_explore_train(tmp):
    """``launch.explore --workload llama2-7b --shape train_4k --algorithm
    bayesopt --gp cuda --clients 2``, as given (ParEGO) and as its EHVI
    variant: every record ok; K1a and K1b launched in both, K2 in the EHVI
    variant (counts set to 0 just before each sweep, read just after, equal
    to the GP's counters); each recorded call held against its plain
    version.  Prints s per build, the build share of wall and evals/s."""
    t0 = time.perf_counter()
    cache = os.path.join(tmp, "train_cache")
    launches_by = {}
    for strategy in ("parego", "ehvi"):
        argv = TRAIN_EXPLORE + ["--gp", "cuda", "--clients", "2",
                                "--samples", str(TRAIN_EXPLORE_SAMPLES), "--cache-dir", cache,
                                "--out", os.path.join(tmp, f"train_{strategy}.csv")]
        calls = []
        with searcher(strategy):
            res, launches, by_form, busy = device_busy(counted_explore, argv, calls)
        check_sweep(res, TRAIN_EXPLORE_SAMPLES, f"explore_train {strategy}")
        need = ("gp_w", "gp_g") + (("gp_ehvi",) if strategy == "ehvi" else ())
        recorded = check_recorded(calls, f"explore_train {strategy}")
        emit("explore_train", strategy=strategy, argv=argv, launches=launches,
             launches_by_form=by_form, recorded_calls={k: v["calls"] for k, v in recorded.items()},
             **explore_summary(res, busy, 2))
        if min(launches[k] for k in need) == 0:
            raise AssertionError(f"explore_train {strategy}: {need} not all launched: "
                                 f"{launches}")
        launches_by[strategy] = launches
    emit("explore_train", phase_seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    return launches_by


# The sharded trainer (slice 7b) on the card's one rank: an NCCL group of one,
# ShardingPolicy(make_mesh_dp_tp(1, 1)), deepseek-moe-16b as train_moe runs it
# (full width, 4 layers, fp32, remat selective, batch 4 x 512), 5 steps with
# the policy and 5 without from the same seed.
SHARDED_STEPS = 5
SHARDED_LOSS_RTOL = 2e-4            # tests/test_sharding.py's tolerance
SHARDED_PREFILL_LAYERS, SHARDED_PREFILL_BATCH, SHARDED_PREFILL_SEQ = 2, 4, 512
SHARDED_PREFILL_RTOL = 1e-5         # fp32 logits, over max |logit|
TRAIN_DEVICE, TRAIN_BACKEND = "cuda", "nccl"
# sharded_ssm: mamba2-780m at full depth under the policy, prefill then greedy steps
SHARDED_SSM_BATCH, SHARDED_SSM_SEQ, SHARDED_SSM_STEPS = 4, 512, 8
SHARDED_SSM_RTOL = 1e-5             # fp32 logits, over max |logit| of the unsharded run
# examples: train_100m's first run and the run it resumes to
EXAMPLE_TRAIN_STEPS, EXAMPLE_RESUME_STEPS = 60, 70


def _moe_train(cfg, flags, seed, policy, batches):
    """``SHARDED_STEPS`` AdamW steps of a fresh model (weights from ``seed``):
    (losses, K5's launches in them)."""
    import torch

    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import Model
    from repro_torch.train import adamw, cosine_schedule, init_train_state, make_train_step

    model = Model(cfg, flags, device=TRAIN_DEVICE, seed=seed, policy=policy)
    opt = adamw(cosine_schedule(1e-3, 1, SHARDED_STEPS))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    sync = torch.cuda.synchronize if TRAIN_DEVICE == "cuda" else (lambda: None)
    sync()
    k5.topk_gating.launches = 0
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b)
        losses.append(met["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = k5.topk_gating.launches
    # ---- end of the counted run
    return model, losses, ms, launches


def phase_train_sharded(seed, tmp):
    """The sharded train path on the card: losses with the policy against
    without (relative gap <= SHARDED_LOSS_RTOL), K5's launches on the
    sharded path (set to 0 just before, read just after; > 0), K5 against
    its plain version under the policy (loss and router gradients),
    ``psum_int8`` over the one-rank group against the local quantise and
    dequantise (bitwise), and a checkpoint of a DTensor train state (reduced
    deepseek-moe-16b, for time) written and restored into its placements; a
    llama2-7b flash prefill with SP off and on (``_sharded_flash_prefill``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.launch.mesh import make_mesh_dp_tp
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import compress
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import (CheckpointManager, adamw, cosine_schedule, init_train_state,
                                   load_train_state)
    from repro_torch.train.checkpoint import _flatten
    from torch.distributed.tensor import DTensor

    t_phase = time.perf_counter()
    _one_rank_group()
    try:
        mesh = make_mesh_dp_tp(1, 1)
        cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
        n_moe = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
        flags = BuildFlags(dtype="float32", remat="selective", sp=False)
        data = SyntheticLM(cfg, DataConfig(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed))
        plain_b = [to_device(data.batch(i), TRAIN_DEVICE) for i in range(SHARDED_STEPS)]
        model, plain, plain_ms, plain_launches = _moe_train(cfg, flags, seed, None, plain_b)
        del model
        policy = ShardingPolicy(mesh)
        sharded_b = [to_device(data.batch(i), TRAIN_DEVICE, policy)
                     for i in range(SHARDED_STEPS)]
        if TRAIN_DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model, sharded, sharded_ms, launches = _moe_train(cfg, flags, seed, policy, sharded_b)
        peak = torch.cuda.max_memory_allocated() if TRAIN_DEVICE == "cuda" else None
        gap = max(abs(a - b) / abs(b) for a, b in zip(sharded, plain))
        want = n_moe * 2 * SHARDED_STEPS
        emit("train_sharded", arch=cfg.name, n_layers=MOE_TRAIN_LAYERS, steps=SHARDED_STEPS,
             mesh=list(zip(policy.axis_names, policy.axis_sizes.values())),
             placements_sample={n: str(p.placements) for n, p in
                                list(model.named_parameters())[:4]},
             losses_sharded=sharded, losses_plain=plain, max_rel_loss_gap=gap,
             rtol=SHARDED_LOSS_RTOL, k5_launches=launches, k5_expected=want,
             plain_k5_launches=plain_launches, step_ms_sharded=sharded_ms,
             step_ms_plain=plain_ms, max_memory_allocated=peak)
        if not gap <= SHARDED_LOSS_RTOL:
            raise AssertionError(f"train_sharded: loss gap {gap} > {SHARDED_LOSS_RTOL}")
        if launches == 0 or (TRAIN_DEVICE == "cuda" and launches != want):
            raise AssertionError(f"train_sharded: K5 launched {launches} times, want {want}")

        # ---- K5 against its plain version on the sharded path
        routers = [p for n, p in model.named_parameters() if n.endswith("router")]
        out = {}
        for label, gate in (("kernel", moe_mod.topk_gating), ("plain", k5.topk_gating_plain)):
            moe_mod.topk_gating = gate
            try:
                with policy.context():
                    loss, _ = model.loss_fn(sharded_b[0])
                    grads = torch.autograd.grad(loss, routers)
                out[label] = (loss.full_tensor().item(),
                              [g.full_tensor() for g in grads])
            finally:
                moe_mod.topk_gating = k5.topk_gating
        loss_err = abs(out["kernel"][0] - out["plain"][0])
        g_scale = max(g.abs().max().item() for g in out["plain"][1])
        g_err = max((a - b).abs().max().item() for a, b in zip(out["kernel"][1], out["plain"][1]))
        ok = (loss_err <= TRAIN_LOSS_RTOL * abs(out["plain"][0])
              and g_err <= ROUTER_GRAD_RTOL * g_scale and g_scale > 0)
        emit("train_sharded_k5", loss_kernel=out["kernel"][0], loss_plain=out["plain"][0],
             loss_abs_err=loss_err, router_grad_max_abs_err=g_err,
             router_grad_max_abs=g_scale, ok=ok)
        if not ok:
            raise AssertionError("train_sharded: K5 on the sharded path disagrees with its "
                                 "plain version")
        del model, out, grads, loss, sharded_b, plain_b

        # ---- psum_int8 over the one-rank group
        x = torch.randn(4096, generator=torch.Generator().manual_seed(seed)).to(TRAIN_DEVICE)
        got = compress.psum_int8(x, (mesh, "data"))
        q, scale = compress._quantize(x)
        same = bool(torch.equal(got, compress._dequantize(q, scale)))
        emit("train_sharded_psum_int8", n=x.numel(), bitwise_equal=same)
        if not same:
            raise AssertionError("psum_int8 over one rank differs from the local Q/DQ")

        # ---- a DTensor train state through a checkpoint
        small = reduced(get_arch(MOE_ARCH))
        opt = adamw(cosine_schedule(1e-3, 1, 10))
        states = []
        for s_ in (seed, seed + 1):
            m = Model(small, flags, device=TRAIN_DEVICE, seed=s_, policy=ShardingPolicy(mesh))
            states.append(init_train_state(m, opt))
        ck = CheckpointManager(os.path.join(tmp, "sharded_ck"), async_save=False)
        ck.save(3, states[0], block=True)
        load_train_state(states[1], ck.restore(3, states[1]))
        flat = [_flatten(st) for st in states]
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        same_ck = all(torch.equal(full(flat[0][k]), full(flat[1][k])) for k in flat[0])
        placed = all(type(flat[1][k]) is type(flat[0][k]) for k in flat[0])
        emit("train_sharded_checkpoint", leaves=len(flat[0]), bitwise_equal=same_ck,
             placements_kept=placed)
        if not (same_ck and placed):
            raise AssertionError("train_sharded: the DTensor checkpoint did not round-trip")
        k3 = _sharded_flash_prefill(seed, mesh)
    finally:
        dist.destroy_process_group()
    emit("train_sharded", phase_seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi_line())
    return {"topk_gating": launches, "flash_attention": k3[False],
            "flash_attention_sp": k3[True]}


def _sharded_flash_prefill(seed, mesh):
    """K3 under a sharding policy, with SP off (batch over data, heads over
    model) and with SP on (q's sequence split over model, gathered for
    K3): each prefill's logits against the unsharded flash prefill of the
    same weights (which runs K3 too); the first K3 call of each sharded
    prefill, its operands and output recorded, held against K3's plain
    version on the same q, k, v (``TOL`` of their dtype, as ``phase_parity``
    holds it); K3's launches on
    each sharded prefill, by SP."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import ShardingPolicy

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=SHARDED_PREFILL_LAYERS)
    flags = BuildFlags(dtype="float32", attn_impl="flash", sp=False)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SHARDED_PREFILL_BATCH, SHARDED_PREFILL_SEQ))).to(TRAIN_DEVICE)
    sync = torch.cuda.synchronize if TRAIN_DEVICE == "cuda" else (lambda: None)
    out = {}
    with torch.no_grad():
        want = Model(cfg, flags, device=TRAIN_DEVICE, seed=seed).prefill({"tokens": tokens})[0]
        for sp in (False, True):
            policy = ShardingPolicy(mesh, sp=sp)
            model = Model(cfg, dataclasses.replace(flags, sp=sp), device=TRAIN_DEVICE,
                          seed=seed, policy=policy)
            placed = policy.batch_shardings({"tokens": tokens})
            first = []
            real = attention.flash_attention

            def recording(q, k, v, **kw):
                o = real(q, k, v, **kw)
                if not first:
                    first.append(((q.clone(), k.clone(), v.clone()), kw, o.clone()))
                return o
            attention.flash_attention = recording
            try:
                sync()
                fa.flash_attention.launches = 0
                got = model.prefill(placed)[0]
                sync()
                launches = fa.flash_attention.launches
                # ---- end of the counted run
            finally:
                attention.flash_attention = real
            got = got.full_tensor()
            del model
            ((q, k, v), kw, o), = first
            del first
            tol = TOL[str(q.dtype).removeprefix("torch.")]
            o_plain = fa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                               window=kw["window"]).float()
            k3_err = (o.float() - o_plain).abs().max().item()
            k3_ok = bool(torch.allclose(o.float(), o_plain, atol=tol, rtol=tol))
            k3_shape = [list(q.shape), list(k.shape)]
            del q, k, v, o, o_plain
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = (launches == cfg.n_layers and err <= SHARDED_PREFILL_RTOL * scale
                  and k3_ok and bool(torch.isfinite(got).all()))
            emit("train_sharded_flash_prefill", arch=cfg.name, n_layers=cfg.n_layers, sp=sp,
                 batch=SHARDED_PREFILL_BATCH, seq=SHARDED_PREFILL_SEQ, k3_launches=launches,
                 k3_call_shapes=k3_shape, k3_vs_plain_max_abs_err=k3_err, k3_tol=tol,
                 logits_max_abs_err=err, logits_max_abs=scale, rtol=SHARDED_PREFILL_RTOL,
                 ok=ok)
            if not ok:
                raise AssertionError(f"train_sharded: K3 on the sharded prefill (sp={sp}) did "
                                     "not launch once per layer, disagrees with its plain "
                                     "version or with the unsharded prefill")
            out[sp] = launches
    return out


def _one_rank_group():
    """An NCCL (``TRAIN_BACKEND``) process group of one rank on a free port."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(TRAIN_BACKEND, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def _ssm_generate(model, tokens, policy):
    """A prefill of ``tokens`` and SHARDED_SSM_STEPS greedy decode steps ->
    (the logits of every step (steps + 1, B, V), the greedy tokens (B,
    steps + 1), K4's launches on the prefill (set to 0 just before, read
    just after), prefill ms, decode ms per step).  With a ``policy`` the
    batch and the caches are placed by it."""
    import torch

    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.serve.engine import pad_caches

    full = (lambda t: t.full_tensor()) if policy is not None else (lambda t: t)
    s = tokens.shape[1]
    with torch.no_grad():
        batch = policy.batch_shardings({"tokens": tokens}) if policy else {"tokens": tokens}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k4.ssd_scan.launches = 0
        logits, caches = model.prefill(batch)
        torch.cuda.synchronize()
        launches = k4.ssd_scan.launches
        # ---- end of the counted prefill
        prefill_ms = (time.perf_counter() - t0) * 1e3
        caches = (policy.place_caches(model, caches, s + SHARDED_SSM_STEPS) if policy
                  else pad_caches(caches, s, s + SHARDED_SSM_STEPS))
        steps = [full(logits)]
        toks = [steps[-1].argmax(-1)]
        t0 = time.perf_counter()
        for pos in range(s, s + SHARDED_SSM_STEPS):
            tok = toks[-1][:, None]
            if policy is not None:
                tok = policy.batch_shardings({"t": tok})["t"]
            logits, caches = model.decode_step(tok, caches, pos)
            steps.append(full(logits))
            toks.append(steps[-1].argmax(-1))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / SHARDED_SSM_STEPS
    return torch.stack(steps), torch.stack(toks, dim=1), launches, prefill_ms, decode_ms


def phase_sharded_ssm(seed):
    """mamba2-780m at full width and depth (48 layers), fp32, with
    ``ssd_impl="cuda"``, under ``ShardingPolicy(make_mesh_dp_tp(1, 1),
    sp=True)`` on an NCCL group of one rank (the Mamba-2 mixer on the
    rank's rows and heads, ``mamba2.mamba_block_sharded``; its decode step
    against the caches in ``cache_spec``'s placements): a prefill of
    SHARDED_SSM_BATCH x SHARDED_SSM_SEQ and SHARDED_SSM_STEPS greedy decode
    steps, once without the policy and once with it, from the same
    weights.  K4's launches on the sharded prefill must equal the 48
    layers; the first layer's K4 call on the sharded prefill is held
    against K4's plain version (``SSD_TOL``); the logits of every step
    within SHARDED_SSM_RTOL of max |logit| of the unsharded run, and the
    greedy tokens equal."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch.mesh import make_mesh_dp_tp
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models import mamba2
    from repro_torch.parallel.sharding import ShardingPolicy

    t_phase = time.perf_counter()
    cfg = get_arch(SSM_ARCH)
    flags = BuildFlags(dtype="float32", ssd_impl="cuda")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SHARDED_SSM_BATCH, SHARDED_SSM_SEQ))).to("cuda")
    model = Model(cfg, flags, device="cuda", seed=seed)
    want, want_toks, plain_launches, plain_pre, plain_dec = _ssm_generate(model, tokens, None)
    del model
    torch.cuda.empty_cache()
    _one_rank_group()
    try:
        policy = ShardingPolicy(make_mesh_dp_tp(1, 1), sp=True)
        model = Model(cfg, flags, device="cuda", seed=seed, policy=policy)
        torch.cuda.reset_peak_memory_stats()
        first = []
        real = mamba2.ssd_scan

        def recording(*args, **kw):
            out = real(*args, **kw)
            if not first:
                first.append(([a.clone() for a in args], kw, [o.clone() for o in out]))
            return out
        mamba2.ssd_scan = recording
        try:
            got, got_toks, launches, pre_ms, dec_ms = _ssm_generate(model, tokens, policy)
        finally:
            mamba2.ssd_scan = real
        peak = torch.cuda.max_memory_allocated()
        del model
        (args, kw, (y, state)), = first
        y_plain, state_plain = k4.ssd_scan_plain(
            *args, chunk=k4.clamp_chunk(kw["chunk"], args[0].shape[1]))
        k4_err = max((y - y_plain).abs().max().item(),
                     (state - state_plain).abs().max().item())
        k4_shape = list(y.shape)
        del first, args, y, state, y_plain, state_plain
    finally:
        dist.destroy_process_group()
    err = (got - want).abs().amax(dim=(1, 2)).tolist()
    scale = want.abs().max().item()
    same_tokens = bool(torch.equal(got_toks, want_toks))
    ok = (launches == cfg.n_layers and k4_err <= SSD_TOL and same_tokens
          and max(err) <= SHARDED_SSM_RTOL * scale and bool(torch.isfinite(got).all()))
    emit("sharded_ssm", arch=cfg.name, n_layers=cfg.n_layers, batch=SHARDED_SSM_BATCH,
         seq=SHARDED_SSM_SEQ, decode_steps=SHARDED_SSM_STEPS, k4_launches=launches,
         k4_launches_unsharded=plain_launches, k4_call_shape=k4_shape,
         k4_vs_plain_max_abs_err=k4_err, k4_tol=SSD_TOL,
         logits_max_abs_err_per_step=err, logits_max_abs=scale, rtol=SHARDED_SSM_RTOL,
         greedy_tokens_equal=same_tokens, prefill_ms_sharded=pre_ms,
         prefill_ms_plain=plain_pre, decode_ms_per_step_sharded=dec_ms,
         decode_ms_per_step_plain=plain_dec, max_memory_allocated_sharded=peak,
         phase_seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line(), ok=ok)
    if not ok:
        raise AssertionError("sharded_ssm: K4's launches, K4 against its plain version, the "
                             "logits or the greedy tokens of the sharded run are off")
    return launches


def _example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(REPO, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(tmp):
    """The four examples' ``main`` in this process on the card:
    serve_batched (K5's launches, set to 0 just before and read just after,
    equal deepseek-moe-16b's MoE layers x its forward calls; K5's first call
    there, its logits and output recorded, held against K5's plain version:
    ids equal, probabilities within TOPK_P_TOL); train_100m at
    its default size, EXAMPLE_TRAIN_STEPS steps and then a second run to
    EXAMPLE_RESUME_STEPS that must print "resumed from step ...", the loss
    falling; quickstart's 40 configs, every record ok; and multi_board_zmq
    where pyzmq imports (else one line says it is missing)."""
    import importlib.util
    import io

    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import moe as moe_mod

    t_phase = time.perf_counter()
    serve = _example("serve_batched")
    first = []
    real = moe_mod.topk_gating

    def recording(logits, k):
        p, ids = real(logits, k)
        if not first:
            first.append((logits.clone(), k, p.clone(), ids.clone()))
        return p, ids
    moe_mod.topk_gating = recording
    try:
        k5.topk_gating.launches = 0
        t0 = time.perf_counter()
        served = serve.main(["--device", "cuda"])
        k5_launches = k5.topk_gating.launches
        # ---- end of the counted run
    finally:
        moe_mod.topk_gating = real
    serve_s = time.perf_counter() - t0
    (logits, k, p, ids), = first
    want_p, want_ids = k5.topk_gating_plain(logits, k)
    ids_equal = bool(torch.equal(ids, want_ids))
    p_err = (p - want_p).abs().max().item()
    moe = reduced(get_arch("deepseek-moe-16b"))
    want = sum(s.ffn == "moe" for s in moe.layer_specs()) * serve.GEN
    emit("examples_serve_batched", seconds=serve_s, k5_launches=k5_launches, k5_expected=want,
         k5_call_shape=list(logits.shape), k5_ids_equal_plain=ids_equal,
         k5_vs_plain_max_abs_p_err=p_err, k5_tol=TOPK_P_TOL,
         tok_s={n: serve.BATCH * serve.GEN / dt for n, (_, dt) in served.items()})
    del first, logits, p, ids, want_p, want_ids
    if k5_launches != want or not ids_equal or p_err > TOPK_P_TOL:
        raise AssertionError(f"examples: serve_batched launched K5 {k5_launches} times "
                             f"(want {want}), or its first call disagrees with the plain "
                             "version")

    train = _example("train_100m")
    ck = os.path.join(tmp, "train_100m")
    t0 = time.perf_counter()
    first = train.main(["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt", ck, "--device", "cuda"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        second = train.main(["--steps", str(EXAMPLE_RESUME_STEPS), "--ckpt", ck,
                             "--device", "cuda"])
    print(buf.getvalue(), end="", flush=True)
    train_s = time.perf_counter() - t0
    resumed = f"resumed from step {EXAMPLE_TRAIN_STEPS}" in buf.getvalue()
    falling = first[-1] < first[0] and second[-1] < first[0]
    emit("examples_train_100m", seconds=train_s, steps=[len(first), len(second)],
         loss_first=first[0], loss_at_first_run_end=first[-1], loss_last=second[-1],
         resumed=resumed, loss_falling=falling)
    if not (resumed and falling and len(second) == EXAMPLE_RESUME_STEPS - EXAMPLE_TRAIN_STEPS):
        raise AssertionError("examples: train_100m did not resume or its loss did not fall")

    t0 = time.perf_counter()
    host = _example("quickstart").main(["--device", "cuda"])
    recs = host.store.records
    ok = len(recs) == 40 and all(r.status == "ok" for r in recs)
    emit("examples_quickstart", seconds=time.perf_counter() - t0, records=len(recs),
         all_ok=ok)
    if not ok:
        raise AssertionError("examples: quickstart's records are not all ok")

    if importlib.util.find_spec("zmq") is None:
        emit("examples_multi_board_zmq", note="pyzmq is missing on this machine; the example "
             "did not run (tests/test_torch_examples.py holds it on the CPU)")
    else:
        import socket

        socks = [socket.socket() for _ in range(3)]
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        res, a, b = [sock.getsockname()[1] for sock in socks]
        for sock in socks:
            sock.close()
        t0 = time.perf_counter()
        host = _example("multi_board_zmq").main(["--device", "cuda", "--cfg-ports",
                                                 f"{a},{b}", "--res-port", str(res)])
        recs = host.store.records
        ok = len(recs) == 48 and all(r.status == "ok" for r in recs)
        emit("examples_multi_board_zmq", seconds=time.perf_counter() - t0,
             records=len(recs), all_ok=ok)
        if not ok:
            raise AssertionError("examples: multi_board_zmq's records are not all ok")
    emit("examples", phase_seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi_line())
    return k5_launches


# ---------------------------------------------------------------------------
# The GP path (the searcher's surrogate): K1a, K1b, K2
# ---------------------------------------------------------------------------

GP_DEVICE = "cuda"
GP_SEED = 3
GP_NOISE = 1e-3               # the GP's default observation noise
GP_REL_TOL = 1e-10            # w, g, new L / L⁻¹ rows: over max(1, max|ref|)
EHVI_TOL = 1e-8               # absolute, as tests/test_gp_pallas.py
SEARCH_D = 14                 # tpu_pod_space(n_chips=256) has 14 knobs
EXPLORE_D = 7                 # llama2-7b's generation space; mamba2-780m's has 6
SEARCH_CAP, SEARCH_N = 8192, 6250   # pow2 capacity and largest active set
# (name, cap, n, m, d, ard) of the append cases: n on a tile edge, just past
# one and at the search path's active set; B = 1, 7 -> 8 and 512; at the
# fold's 128-row tiles n one before, on and one past an edge, B on both
# sides of the tell/fold switch (8 | 16), cap below one tile, and n = 0; last
# the explore sweep's shapes (d = 7 and 6, tells at B = 1, the 12 -> 16 fold)
GP_APPEND_CASES = [
    ("cap64_first", 64, 0, 7, SEARCH_D, False),
    ("cap64_edge", 64, 48, 7, SEARCH_D, False),
    ("cap64_past_edge_ard", 64, 17, 16, SEARCH_D, True),
    ("cap64_fold_b32", 64, 20, 32, SEARCH_D, False),
    ("cap64_n0_b64", 64, 0, 64, SEARCH_D, False),
    ("edge_b512", SEARCH_CAP, 6144, 512, SEARCH_D, False),
    ("past_edge_b8_ard", SEARCH_CAP, 6145, 7, SEARCH_D, True),
    ("active_b1", SEARCH_CAP, SEARCH_N, 1, SEARCH_D, False),
    ("active_b512_ard", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, True),
    ("tile_before_b16", 1024, 127, 9, SEARCH_D, False),
    ("tile_on_b8", 1024, 128, 8, SEARCH_D, False),
    ("tile_past_b16_ard", 1024, 129, 16, SEARCH_D, True),
    ("tile_on_b512", 1024, 128, 512, SEARCH_D, False),
    ("tile_past_b1", 1024, 129, 1, SEARCH_D, False),
    ("odd_tiles_b512", 1024, 384, 512, SEARCH_D, False),
    ("n0_b512", 1024, 0, 512, SEARCH_D, False),
    ("n0_b1", SEARCH_CAP, 0, 1, SEARCH_D, False),
    ("explore_d7_first_b1", 64, 0, 1, EXPLORE_D, False),
    ("explore_d7_tell_b1", 256, 150, 1, EXPLORE_D, False),
    ("explore_d7_fold_b12", 256, 100, 12, EXPLORE_D, False),
    ("explore_d6_tell_b1_ard", 64, 31, 1, EXPLORE_D - 1, True),
    ("explore_d6_fold_b12", 64, 20, 12, EXPLORE_D - 1, False),
]
# (name, cap, n, P, d, front points, ard) of the EHVI cases: S = pow2 + 1;
# n = 0, 1 and one below, on and one past a 64-row step edge (where K2's
# row splits are cut), P off and on its 64-candidate tiles
GP_EHVI_CASES = [
    ("cap64_s2", 64, 40, 512, SEARCH_D, 1, False),
    ("search_s2", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 1, False),
    ("search_s17", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 12, False),
    ("search_s129_ard", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 100, True),
    ("n0_p511", SEARCH_CAP, 0, 511, SEARCH_D, 12, False),
    ("n1_p1", SEARCH_CAP, 1, 1, SEARCH_D, 1, False),
    ("step_below_p513", SEARCH_CAP, 6143, 513, SEARCH_D, 12, False),
    ("step_on_p511", SEARCH_CAP, 6144, 511, SEARCH_D, 12, False),
    ("step_past_p1_ard", SEARCH_CAP, 6145, 1, SEARCH_D, 12, True),
    ("explore_d7_s46", 256, 199, 512, EXPLORE_D, 45, False),
    ("explore_d7_p37", 256, 160, 37, EXPLORE_D, 20, False),
    ("explore_d6_s9_ard", 64, 31, 512, EXPLORE_D - 1, 8, True),
]
SMALL_FEED, SMALL_BLOCK, SMALL_CYCLES = 1000, 64, 30
MAIN_CHECKPOINTS = (10_000, 100_000)
FOLD_BLOCK = 512
TIMED_CYCLES = 20
PROFILE_CYCLES = 5


def toy_objectives(space, knobs):
    """The deterministic objectives of ``tests/test_gp_pallas.py``."""
    import numpy as np

    x = space.encode(knobs)
    time_ = 2.0 - 1.2 * x[0] + 0.4 * x[1] + 0.1 * np.sin(7 * x.sum())
    power = 0.5 + 1.5 * x[0] ** 2 + 0.2 * x[2]
    return np.array([time_, power])


def f64(a):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=GP_DEVICE)


def gp_state(cap, n, m, d, ard, seed):
    """A real GP state: n random rows factored by the torch tier's masked
    refactor, and an m-row block padded to its pow2 height.  Returns
    (ls, xb, lb, lib, xnew, ls2, ils, xs, xq): the last four are what K1a
    sees (the new rows written into X, and both pre-scaled under ARD)."""
    import numpy as np

    from repro_torch.core.search import gp_torch

    rng = np.random.default_rng(seed)
    ls = rng.uniform(0.5, 1.5, d) if ard else 0.3
    xrows = np.zeros((cap, d))
    xrows[:n] = rng.random((n, d))
    xb = f64(xrows)
    lb, lib = gp_torch._refactor(xb, n, ls, GP_NOISE, 1.0)
    xpad = np.zeros((1 << max(m - 1, 0).bit_length(), d))
    xpad[:m] = rng.random((m, d))
    xnew = f64(xpad)
    xs = xb.clone()
    xs[n:n + len(xpad)] = xnew
    if ard:
        ils = f64(1.0 / ls)
        return ls, xb, lb, lib, xnew, 1.0, ils, xs * ils, xnew * ils
    return ls, xb, lb, lib, xnew, ls * ls, None, xs, xnew


def ehvi_case(cap, n, P, d, n_front, ard, seed):
    """K2's inputs: random rows and weights, a random front on x + y = 1
    padded to pow2 with zero-width segments, its staircase and the means."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xb = np.zeros((cap, d))
    xb[:n] = rng.random((n, d))
    alpha = np.zeros((cap, 2))
    alpha[:n] = rng.standard_normal((n, 2)) * 0.05
    front = np.sort(rng.random(n_front))
    F = 1 << max(n_front - 1, 0).bit_length()
    fpad = np.stack([np.concatenate([front, np.full(F - n_front, 1.2)]),
                     np.concatenate([1.0 - front, np.full(F - n_front, 1.0 - front[-1])])], 1)
    ref = np.array([1.2, 1.1])
    stair = np.stack([np.concatenate([[-np.inf], fpad[:, 0]]),
                      np.concatenate([fpad[:, 0], ref[:1]]),
                      np.concatenate([ref[1:], fpad[:, 1]])])
    ymd = np.array([[0.2, 0.3], [0.2, 0.3]])
    ls = rng.uniform(0.5, 1.5, d) if ard else 0.3
    ils = f64(1.0 / ls) if ard else None
    xq = f64(rng.random((P, d)))
    xs = f64(xb)
    return dict(ls=ls, ls2=1.0 if ard else ls * ls, xb=xs, alpha=f64(alpha),
                xq=xq, xqs=xq if ils is None else xq * ils,
                xs=xs if ils is None else xs * ils, stair=f64(stair), ymd=f64(ymd),
                fpad=f64(fpad), ref=f64(ref), S=stair.shape[1])


def abs_rel(got, want):
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def phase_gp_parity():
    """K1a, K1b and K2 against their plain versions on the card, float64;
    each launched twice on the same inputs must repeat bitwise."""
    import torch

    from repro_torch.core.search import gp_torch
    from repro_torch.kernels import gp_ops

    errs = {"gp_w": 0.0, "gp_g": 0.0, "gp_ehvi": 0.0}
    for i, (name, cap, n, m, d, ard) in enumerate(GP_APPEND_CASES):
        ls, xb, lb, lib, xnew, ls2, ils, xs, xq = gp_state(cap, n, m, d, ard, GP_SEED + i)
        w = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        w2 = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        g = gp_ops.gp_g(w, lib, n)
        g2 = gp_ops.gp_g(w, lib, n)
        torch.cuda.synchronize()
        err_w = abs_rel(w, gp_ops.gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=1.0))
        err_g = abs_rel(g, gp_ops.gp_g_plain(w, lib, n))
        # the whole append against the torch tier's dense one on copies
        bufs = [xb.clone(), lb.clone(), lib.clone()]
        ok = gp_ops.gp_append(*bufs, n, m, xnew, ils, GP_NOISE, ls2=ls2, signal=1.0)
        dense = [xb.clone(), lb.clone(), lib.clone()]
        ok_dense = bool(gp_torch._append(*dense, n, m, xnew, ls, GP_NOISE, 1.0))
        B = xnew.shape[0]
        err_l = abs_rel(bufs[1][n:n + B], dense[1][n:n + B])
        err_li = abs_rel(bufs[2][n:n + B], dense[2][n:n + B])
        zero = all(not t[n + m:].any() and not t[:, n + m:].any() for t in bufs[1:])
        repeat = bool(torch.equal(w, w2) and torch.equal(g, g2))
        tail = w.clone()
        tail[n:] = float("nan")          # K1b reads only the rows < n of w
        rows_below_n = bool(torch.equal(gp_ops.gp_g(tail, lib, n), g))
        rel = max(err_w[1], err_g[1], err_l[1], err_li[1])
        passed = ok and ok_dense and zero and repeat and rows_below_n and rel <= GP_REL_TOL
        emit("gp_parity", kernel="gp_append", case=name, cap=cap, n=n, m=m, B=B, d=d,
             ard=ard, tiles=gp_ops.tiles(B, cap, n), w_err=err_w, g_err=err_g,
             l_rows_err=err_l, lib_rows_err=err_li, tol_rel=GP_REL_TOL, ok_flag=ok,
             ok_flag_dense=ok_dense, zero_invariant=zero, bitwise_repeat=repeat,
             g_reads_rows_below_n=rows_below_n, ok=passed)
        if not passed:
            raise AssertionError(f"gp_append case {name} disagrees with its plain version")
        errs["gp_w"] = max(errs["gp_w"], err_w[0])
        errs["gp_g"] = max(errs["gp_g"], err_g[0])
        del xb, lb, lib, bufs, dense
        torch.cuda.empty_cache()
    for i, (name, cap, n, P, d, n_front, ard) in enumerate(GP_EHVI_CASES):
        c = ehvi_case(cap, n, P, d, n_front, ard, GP_SEED + 100 + i)
        args = (c["xqs"], c["xs"], c["alpha"], n, c["stair"], c["ymd"])
        got = gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)
        got2 = gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)
        torch.cuda.synchronize()
        want = gp_ops.gp_ehvi_plain(*args, ls2=c["ls2"], signal=1.0)
        err = (got - want).abs().max().item()
        repeat = bool(torch.equal(got, got2))
        positive = int((want > 0).sum().item())
        passed = repeat and err <= EHVI_TOL and positive > 0
        emit("gp_parity", kernel="gp_ehvi", case=name, cap=cap, n=n, P=P, d=d, S=c["S"],
             ard=ard, max_abs_err=err, tol=EHVI_TOL, positive_scores=positive,
             max_score=want.max().item(), bitwise_repeat=repeat, ok=passed)
        if not passed:
            raise AssertionError(f"gp_ehvi case {name} disagrees with its plain version")
        errs["gp_ehvi"] = max(errs["gp_ehvi"], err)
    return errs


def run_small(cls, kw, mode, space):
    """One searcher fed SMALL_FEED toy observations in SMALL_BLOCK-row blocks
    (one ask per block folds it in), then SMALL_CYCLES ask/tell cycles."""
    import numpy as np

    extra = {} if mode == "incremental" else {"device": GP_DEVICE}
    algo = cls(space, seed=GP_SEED, pool_size=512, inducing_threshold=None,
               gp_mode=mode, **kw, **extra)
    rng = np.random.default_rng(GP_SEED)
    picks, n = [], 0
    t0 = time.perf_counter()
    while n < SMALL_FEED:
        for _ in range(min(SMALL_BLOCK, SMALL_FEED - n)):
            c = space.sample(rng)
            algo.tell(c, toy_objectives(space, c))
            n += 1
        picks.append(algo.ask(1)[0])
    for _ in range(SMALL_CYCLES):
        c = algo.ask(1)[0]
        algo.tell(c, toy_objectives(space, c))
        picks.append(c)
    return picks, algo._gp.stats() if mode != "incremental" else {}, time.perf_counter() - t0


def phase_search_small():
    """BayesOpt (ehvi, parego) and PAL: the cuda tier's picks equal the
    numpy incremental tier's on the host, at n = 1,000+."""
    from repro_torch.core import BayesOpt, PAL, tpu_pod_space

    space = tpu_pod_space(n_chips=256)
    for name, cls, kw in (("bayesopt_ehvi", BayesOpt, {"strategy": "ehvi"}),
                          ("bayesopt_parego", BayesOpt, {"strategy": "parego"}),
                          ("pal", PAL, {})):
        want, _, host_s = run_small(cls, kw, "incremental", space)
        got, stats, cuda_s = run_small(cls, kw, "cuda", space)
        same = got == want
        emit("search_small", searcher=name, picks=len(got),
             identical=sum(a == b for a, b in zip(got, want)), equal=same,
             incremental_seconds=host_s, cuda_seconds=cuda_s, gp=stats)
        if not same:
            raise AssertionError(f"{name}: cuda picks differ from incremental")


def run_search_tier(mode, follow=None):
    """BayesOpt(ehvi) on tpu_pod_space(n_chips=256), pool 512, default
    inducing threshold (5000), fed ``rng.random(2) + 0.5`` observations in
    FOLD_BLOCK-row blocks to each checkpoint, then a thin, one warm cycle
    and TIMED_CYCLES timed tell+ask cycles (``benchmarks/common.py::
    bign_ask_curve``).  With ``follow`` (the cuda run's picks) every ask
    tells and records the followed pick, so both tiers see one feed."""
    import collections
    import statistics

    import numpy as np
    import torch

    from repro_torch.core import BayesOpt, tpu_pod_space

    space = tpu_pod_space(n_chips=256)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    algo = BayesOpt(space, seed=SEED, n_init=8, pool_size=512, strategy="ehvi",
                    gp_mode=mode, device=GP_DEVICE)
    gp = algo._gp
    rng = np.random.default_rng(SEED)
    spent = collections.defaultdict(float)   # host seconds by step, timed cycles
    timing, scores, picks = [False], [], []

    def timed(obj, name, record=False):
        inner = getattr(obj, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if timing[0]:
                spent[name] += time.perf_counter() - t0
                if record:
                    scores.append((np.array(args[0]), out))
            return out
        setattr(obj, name, wrapper)

    for obj, name in ((algo, "_fresh_pool"), (algo, "observed_values"),
                      (algo, "_update_front"), (gp, "observe"), (gp, "fit_y_multi")):
        timed(obj, name)
    timed(gp, "score_ehvi", record=True)

    def ask():
        c = algo.ask(1)[0]
        picks.append(c)
        if follow is None:
            return c
        want = follow[len(picks) - 1]
        if c != want:          # keep the dedup set on the followed feed
            algo._seen.discard(algo._flat_key(c))
            algo._seen.add(algo._flat_key(want))
        return want

    def cycle():
        c = ask()
        algo.tell(c, rng.random(2) + 0.5)

    out, n = {}, 0
    for ck in MAIN_CHECKPOINTS:
        t0 = time.perf_counter()
        while n < ck:
            for _ in range(min(FOLD_BLOCK, ck - n)):
                algo.tell(space.sample(rng), rng.random(2) + 0.5)
                n += 1
            ask()              # folds the pending block into the GP
        feed_s = time.perf_counter() - t0
        if gp.n_total > int(gp.inducing_threshold * gp.inducing_overflow):
            gp._thin()         # a deterministic active set for the timed cycles
        cycle()                # warm: the first 1-row append at this capacity
        ask()
        spent.clear()
        timing[0] = True
        cycles = []
        for _ in range(TIMED_CYCLES):
            t0 = time.perf_counter()
            cycle()
            cycles.append(time.perf_counter() - t0)
        timing[0] = False
        n += TIMED_CYCLES + 1
        total = sum(cycles)
        # the last timed ask's posterior means (its fit, its pool), outside
        # the timed window: they test the factor state even where every
        # EHVI score is 0
        means = gp.predict_mean_multi(scores[-1][0])
        out[ck] = {"tell_ask_ms": statistics.median(cycles) * 1e3,
                   "tell_ask_ms_min": min(cycles) * 1e3, "tell_ask_ms_max": max(cycles) * 1e3,
                   "n_active": len(gp), "n_total": gp.n_total, "capacity": gp._cap,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "feed_seconds": feed_s,
                   "host_share": {k: v / total for k, v in spent.items()},
                   "means": means}
    prof = profile(cycle, calls=PROFILE_CYCLES)
    prof["device_busy_share"] = prof["device_busy_ms"] / out[MAIN_CHECKPOINTS[-1]]["tell_ask_ms"]
    return out, prof, gp.stats(), picks, scores


def phase_search_main():
    """The GP path at the size of bign_ask_curve, cuda then torch on one feed.
    K1a/K1b/K2 launch counts: set to 0 just before the cuda run, read just
    after, and held against the GP's own counters."""
    import numpy as np

    from repro_torch.kernels import gp_ops

    kernels = (gp_ops.gp_w, gp_ops.gp_g, gp_ops.gp_ehvi)
    for k in kernels:
        k.launches = 0
    for k in kernels[:2]:
        k.launches_by_form = dict.fromkeys(k.launches_by_form, 0)
    t0 = time.perf_counter()
    cuda_out, cuda_prof, cuda_stats, cuda_picks, cuda_scores = run_search_tier("cuda")
    cuda_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    by_form = {k.__name__: dict(k.launches_by_form) for k in kernels[:2]}
    # ---- end of the GP path's counted run
    want = {"gp_w": cuda_stats["cuda_appends"], "gp_g": cuda_stats["cuda_appends"],
            "gp_ehvi": cuda_stats["cuda_scores"]}
    t0 = time.perf_counter()
    torch_out, torch_prof, torch_stats, torch_picks, torch_scores = run_search_tier(
        "torch", follow=cuda_picks)
    torch_s = time.perf_counter() - t0
    after = {k.__name__: k.launches for k in kernels}
    if len(cuda_scores) != len(torch_scores) or not all(
            np.array_equal(a[0], b[0]) for a, b in zip(cuda_scores, torch_scores)):
        raise AssertionError("search_main: the two tiers scored different pools")
    score_err = max(float(np.max(np.abs(a[1] - b[1]))) for a, b in zip(cuda_scores, torch_scores))
    positive = sum(int((a[1] > 0).sum()) for a in cuda_scores)
    mean_err = max(float(np.max(np.abs(cuda_out[ck].pop("means") - torch_out[ck].pop("means"))))
                   for ck in MAIN_CHECKPOINTS)
    same = sum(a == b for a, b in zip(cuda_picks, torch_picks)) / len(cuda_picks)
    for ck in MAIN_CHECKPOINTS:
        for mode, out in (("cuda", cuda_out), ("torch", torch_out)):
            emit("search_main", checkpoint=ck, gp_mode=mode, **out[ck])
    emit("search_main_profile", checkpoint=MAIN_CHECKPOINTS[-1], cycles=PROFILE_CYCLES,
         cuda=cuda_prof, torch=torch_prof)
    emit("search_main", launches=launches, launches_by_form=by_form, expected=want,
         launches_after_torch_run=after,
         cuda_stats=cuda_stats, torch_stats=torch_stats, timed_asks=len(cuda_scores),
         max_ehvi_diff=score_err, positive_scores=positive, max_mean_diff=mean_err,
         ehvi_tol=EHVI_TOL, identical_pick_share=same,
         asks=len(cuda_picks), cuda_seconds=cuda_s, torch_seconds=torch_s)
    if launches != want or after != launches:
        raise AssertionError(f"GP kernel launches {launches} (after the torch run "
                             f"{after}) do not match the GP's counters {want}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a GP kernel was not launched on the search path: {launches}")
    if any(sum(f.values()) != launches[k] or min(f.values()) == 0 for k, f in by_form.items()):
        raise AssertionError(f"K1a/K1b launches by form {by_form} do not add up to "
                             f"{launches} or miss a form")
    if score_err > EHVI_TOL or mean_err > EHVI_TOL:
        raise AssertionError(f"cuda and torch EHVI scores differ by {score_err}, "
                             f"posterior means by {mean_err}")
    return launches


# The paper's explore loop (slice 2b): its command at full width, llama2-7b's
# generation workload on the reference's modeled 8-chip board.
EXPLORE_CMD = ["--workload", "llama2-7b", "--shape", "generate", "--algorithm", "bayesopt",
               "--seed", "0"]
EXPLORE_SAMPLES = 200
EXPLORE_SIDE = (("mamba2-780m", []),                         # the ssd_chunk knob
                ("deepseek-moe-16b", ["--batch-size", "12"]))
EXPLORE_SIDE_SAMPLES = 32


@contextlib.contextmanager
def searcher(strategy):
    """``--algorithm bayesopt`` builds BayesOpt with this acquisition: the
    CLI keeps the reference's flags, which choose none (ParEGO)."""
    from repro_torch.core.search import ALGORITHMS, BayesOpt

    default = ALGORITHMS["bayesopt"]
    ALGORITHMS["bayesopt"] = functools.partial(BayesOpt, strategy=strategy)
    try:
        yield
    finally:
        ALGORITHMS["bayesopt"] = default


class Recorder:
    """``kernel`` (a gp_ops wrapper) as called, keeping a copy of each
    call's inputs and output in ``calls``.  It takes the wrapper's place
    among the module's globals, where the wrapper counts its own launches
    (``gp_w.launches += 1``): the counters read and written through it are
    the wrapper's."""

    def __init__(self, kernel, calls):
        self.kernel, self.calls = kernel, calls
        self.__name__ = kernel.__name__

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, value):
        self.kernel.launches = value

    @property
    def launches_by_form(self):
        return self.kernel.launches_by_form

    def __call__(self, *args, **kw):
        import torch

        def keep(a):
            return a.clone() if isinstance(a, torch.Tensor) else a

        out = self.kernel(*args, **kw)
        self.calls.append((self.kernel, tuple(keep(a) for a in args), dict(kw), out.clone()))
        return out


def counted_explore(argv, record=None):
    """One sweep through ``launch.explore.run`` (``main``'s sweep) with the
    GP kernels' counts set to 0 just before and read just after; they must
    equal the GP's own counters.  With a ``record`` list, every K1a, K1b
    and K2 call of the sweep appends its inputs and output to it."""
    from repro_torch.kernels import gp_ops
    from repro_torch.launch import explore

    kernels = (gp_ops.gp_w, gp_ops.gp_g, gp_ops.gp_ehvi)
    for k in kernels:
        k.launches = 0
    for k in kernels[:2]:
        k.launches_by_form = dict.fromkeys(k.launches_by_form, 0)
    if record is not None:          # gp_append/gp_fused_ehvi look them up here
        for k in kernels:
            setattr(gp_ops, k.__name__, Recorder(k, record))
    try:
        res = explore.run(argv)
    finally:
        for k in kernels:
            setattr(gp_ops, k.__name__, k)
    launches = {k.__name__: k.launches for k in kernels}
    by_form = {k.__name__: dict(k.launches_by_form) for k in kernels[:2]}
    # ---- end of the counted run
    gp = getattr(res.algo, "_gp", None)
    stats = gp.stats() if hasattr(gp, "stats") else {}     # numpy tiers: none
    want = {"gp_w": stats.get("cuda_appends", 0), "gp_g": stats.get("cuda_appends", 0),
            "gp_ehvi": stats.get("cuda_scores", 0)}
    if launches != want:
        raise AssertionError(f"explore {argv}: GP kernel launches {launches} do not match "
                             f"the GP's counters {want}")
    if record is not None:
        kept = {k.__name__: sum(c[0] is k for c in record) for k in kernels}
        if kept != launches:
            raise AssertionError(f"explore {argv}: recorded calls {kept} != launches "
                                 f"{launches}")
    return res, launches, by_form


def check_recorded(calls, label):
    """Each recorded K1a/K1b/K2 call of a sweep against its plain version on
    the same inputs (K1a/K1b: GP_REL_TOL over max(1, max|plain|); K2:
    EHVI_TOL absolute) and against a relaunch on them (bitwise).  The
    relaunches come after the sweep's counts were read."""
    import torch

    from repro_torch.kernels import gp_ops

    plain = {"gp_w": gp_ops.gp_w_plain, "gp_g": gp_ops.gp_g_plain,
             "gp_ehvi": gp_ops.gp_ehvi_plain}
    seen = {}
    for kernel, args, kw, out in calls:
        name = kernel.__name__
        want = plain[name](*args, **kw)
        again = kernel(*args, **kw)
        torch.cuda.synchronize()
        err, rel = abs_rel(out, want)
        ok = (rel <= GP_REL_TOL) if name != "gp_ehvi" else (err <= EHVI_TOL)
        repeat = bool(torch.equal(again, out))
        if name == "gp_w":
            lib, xs, xq, n = args[:4]
            shape = {"d": xs.shape[1], "cap": xs.shape[0], "B": xq.shape[0],
                     "form": gp_ops.form(xq.shape[0])}
        elif name == "gp_g":
            w, lib, n = args
            shape = {"cap": w.shape[0], "B": w.shape[1], "form": gp_ops.form(w.shape[1])}
        else:
            xq, xs, alpha, n, stair = args[:5]
            shape = {"d": xs.shape[1], "cap": xs.shape[0], "P": xq.shape[0],
                     "S": stair.shape[1]}
        r = seen.setdefault(name, {"calls": 0, "max_abs_err": 0.0, "max_rel_err": 0.0,
                                   "bitwise_repeat": True, "n": [int(n), int(n)],
                                   **{k: set() for k in shape}})
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        r["bitwise_repeat"] &= repeat
        r["n"] = [min(r["n"][0], int(n)), max(r["n"][1], int(n))]
        for k, v in shape.items():
            r[k].add(v)
        if not (ok and repeat):
            raise AssertionError(f"{label}: {name} at {shape}, n={int(n)} disagrees with "
                                 f"its plain version ({err}, {rel}) or with its relaunch "
                                 f"(bitwise {repeat})")
    summary = {name: {k: (sorted(v) if isinstance(v, set) else v) for k, v in r.items()}
               for name, r in seen.items()}
    emit("explore_kernels", run=label, tol_rel=GP_REL_TOL, ehvi_tol=EHVI_TOL,
         kernels=summary, ok=True)
    calls.clear()
    return summary


def device_busy(fn, *args):
    """fn(*args) under the profiler, tracing the card only (the builds'
    meta ops would swamp a CPU trace): its result and the device kernel
    time it recorded, summed and in events (the trace may drop some: §7
    of PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (*out, {"device_busy_ms": sum(e.device_time_total for e in events) / 1e3,
                   "events": len(events)})


def check_sweep(res, n, label):
    """The sweep's results by the repo's own means: n ok records with finite
    time, power and energy, power inside the modeled envelope."""
    import math

    from repro_torch.roofline import hw

    ok = res.store.ok_records()
    bad = [r for r in res.store.records if r.status != "ok"]
    if len(ok) != n or bad:
        raise AssertionError(f"{label}: {len(ok)} ok of {n}; not ok: "
                             f"{[(r.config_id, r.status, r.metrics) for r in bad[:3]]}")
    for r in ok:
        m = r.metrics
        if not (math.isfinite(m["time_s"]) and m["time_s"] > 0
                and hw.IDLE_W <= m["power_w"] <= hw.IDLE_W + hw.COMPUTE_W + hw.HBM_W
                and math.isfinite(m["energy_j"])):
            raise AssertionError(f"{label}: config {r.config_id} has metrics {m}")


def sweep_columns(path):
    """Knob and metric columns per config_id of an explore CSV."""
    import csv

    with open(path) as f:
        return {int(r["config_id"]): {k: v for k, v in r.items()
                                      if k.startswith(("knob.", "metric."))}
                for r in csv.DictReader(f)}


def explore_summary(res, busy, clients):
    """The numbers of one timed sweep, as ``emit`` keywords."""
    from repro_torch.core import hypervolume

    t = res.timings
    pts = res.store.objective_matrix(["time_s", "power_w"])
    wall = t["wall_s"]
    return dict(wall_seconds=wall, evals_per_s=len(pts) / wall, builds=t["builds"],
                seconds_per_build=t["build_s"] / max(t["builds"], 1),
                build_share=t["build_s"] / (clients * wall),
                search_share=(t["ask_s"] + t["tell_s"]) / wall,
                dispatch_share=t["dispatch_s"] / wall,
                tell_ask_ms_per_cycle=(t["ask_s"] + t["tell_s"]) / max(t["asks"], 1) * 1e3,
                asks=t["asks"], tells=t["tells"], timings=t,
                front_size=len(res.store.pareto_front(["time_s", "power_w"])),
                hypervolume=float(hypervolume(pts, pts.max(0) * 1.1)),
                gp=res.algo._gp.stats(), device_busy_share=busy["device_busy_ms"] / 1e3 / wall,
                device=busy)


def phase_explore_main(tmp):
    """The paper's command on the port: llama2-7b, generate, bayesopt, --gp
    cuda, 200 samples, 2 clients, as given (ParEGO) and as its EHVI variant
    (K2 runs as well as K1a/K1b); then at one client --gp cuda against --gp
    incremental (both acquisitions) on one --cache-dir; then mamba2-780m
    and deepseek-moe-16b at full width.  The one-client and side sweeps'
    kernel calls are held against their plain versions afterwards.  The
    sweeps' CSVs and build cache stay in ``tmp`` for the later phases;
    returns their paths."""
    import numpy as np

    for strategy in ("parego", "ehvi"):
        argv = EXPLORE_CMD + ["--gp", "cuda", "--clients", "2",
                              "--samples", str(EXPLORE_SAMPLES),
                              "--out", os.path.join(tmp, f"main_{strategy}.csv")]
        with searcher(strategy):
            res, launches, by_form, busy = device_busy(counted_explore, argv)
        check_sweep(res, EXPLORE_SAMPLES, f"explore_main {strategy}")
        need = ("gp_w", "gp_g") + (("gp_ehvi",) if strategy == "ehvi" else ())
        if min(launches[k] for k in need) == 0:
            raise AssertionError(f"explore_main {strategy}: a GP kernel of the path "
                                 f"was not launched: {launches}")
        emit("explore_main", strategy=strategy,
             variant="command as given" if strategy == "parego" else "EHVI variant",
             argv=argv, launches=launches, launches_by_form=by_form,
             **explore_summary(res, busy, 2))

    cache = os.path.join(tmp, "cache")
    for strategy in ("ehvi", "parego"):
        cols = {}
        for gp in ("cuda", "incremental"):
            out = os.path.join(tmp, f"{strategy}_{gp}.csv")
            calls = [] if gp == "cuda" else None
            with searcher(strategy):
                res, launches, by_form = counted_explore(
                    EXPLORE_CMD + ["--gp", gp, "--clients", "1",
                                   "--samples", str(EXPLORE_SAMPLES), "--cache-dir", cache,
                                   "--out", out], record=calls)
            check_sweep(res, EXPLORE_SAMPLES, f"explore_parity {strategy} {gp}")
            cols[gp] = sweep_columns(out)
            t = res.timings
            emit("explore_parity", strategy=strategy, gp=gp, builds=t["builds"],
                 wall_seconds=t["wall_s"], build_seconds=t["build_s"],
                 tell_ask_ms_per_cycle=(t["ask_s"] + t["tell_s"]) / max(t["asks"], 1) * 1e3,
                 launches=launches, launches_by_form=by_form,
                 recorded=calls is not None,
                 disk_hits=res.clients[0].cache_info().get("disk_hits"))
            if calls is not None:
                check_recorded(calls, f"explore_parity {strategy}")
        same = sum(cols["cuda"].get(i) == row for i, row in cols["incremental"].items())
        emit("explore_parity", strategy=strategy, configs=len(cols["incremental"]),
             identical_rows=same)
        if cols["cuda"] != cols["incremental"]:
            raise AssertionError(f"explore_parity {strategy}: --gp cuda and --gp "
                                 f"incremental differ ({same} of "
                                 f"{len(cols['incremental'])} rows identical)")

    for arch, extra in EXPLORE_SIDE:
        argv = (["--workload", arch, "--shape", "generate", "--algorithm", "bayesopt",
                 "--seed", "0", "--gp", "cuda", "--clients", "2",
                 "--samples", str(EXPLORE_SIDE_SAMPLES),
                 "--out", os.path.join(tmp, f"{arch}.csv")] + extra)
        calls = []
        with searcher("ehvi"):
            res, launches, by_form = counted_explore(argv, record=calls)
        check_sweep(res, EXPLORE_SIDE_SAMPLES, f"explore {arch}")
        if min(launches.values()) == 0:
            raise AssertionError(f"explore {arch}: a GP kernel was not launched: "
                                 f"{launches}")
        t = res.timings
        emit("explore_side", arch=arch, argv=argv, strategy="ehvi",
             wall_seconds=t["wall_s"],
             builds=t["builds"], seconds_per_build=t["build_s"] / max(t["builds"], 1),
             launches=launches, launches_by_form=by_form,
             knobs=sorted({k for r in res.store.records for k in r.knobs}),
             time_range=[float(np.min(res.store.objective_matrix(["time_s"]))),
                         float(np.max(res.store.objective_matrix(["time_s"])))])
        check_recorded(calls, f"explore {arch}")
    return {"cache": cache, "parego_cuda": os.path.join(tmp, "parego_cuda.csv"),
            "csvs": [os.path.join(tmp, f) for f in sorted(os.listdir(tmp))
                     if f.endswith(".csv") and not f.startswith(("mamba", "deepseek"))]}


# The paper's command made durable (slice 6): crashed twice, resumed in a
# fresh process each time.  70 lands past two snapshots at the default
# --checkpoint-every 25; 10 before any, so the whole log replays.
DURABLE_CRASHES = (70, 10)
EXPLORE_CHECKPOINT_EVERY = 25          # launch.explore's default --checkpoint-every
CRASH_EXIT = 42
CHILD_TIMEOUT_S = 600
# The multi-tenant service on the paper's workload: three tenants on two
# clients sharing one fleet store.
SERVE_TENANTS = [{"name": "bayesopt", "algorithm": "bayesopt", "gp": "cuda", "samples": 100,
                  "weight": 2},
                 {"name": "pal", "algorithm": "pal", "gp": "cuda", "samples": 50},
                 {"name": "random", "algorithm": "random", "samples": 50}]


def float_hex(v):
    """A CSV cell as ``float.hex`` where it is a number (a metric may name
    the bottleneck instead)."""
    try:
        return float(v).hex()
    except ValueError:
        return v


def hexed(rows):
    """``sweep_columns`` rows with every numeric metric as ``float.hex``."""
    return {cid: {k: (float_hex(v) if k.startswith("metric.") else v) for k, v in r.items()}
            for cid, r in rows.items()}


def csv_ids(path):
    import csv

    with open(path) as f:
        return [int(r["config_id"]) for r in csv.DictReader(f)]


def port_env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def resume_child(argv_json):
    """``--resume-child ARGV``: one resumed sweep in this fresh process,
    through ``counted_explore`` (its K1a/K1b/K2 launches equal the GP's
    counters; every call recorded and held against its plain version);
    prints what the parent reads as its last line."""
    argv = json.loads(argv_json)
    calls = []
    res, launches, by_form = counted_explore(argv, record=calls)
    recorded = check_recorded(calls, "explore_durable resume")
    info = dict(res.resume or {})
    info["outstanding"] = sorted(info.get("outstanding", ()))   # the ids re-submitted
    print(json.dumps({"resume_child": {"launches": launches, "launches_by_form": by_form,
                                       "replay": info, "rows": len(res.store.records),
                                       "timings": res.timings, "recorded": recorded}}),
          flush=True)
    return 0


def capacity_probe():
    """A cuda-tier BayesOpt (ParEGO, the paper's space) snapshotted at 31
    rows on a 64-row capacity (a 5-row fold padded to 8), restored with the
    snapshot's capacity and without it (at 32 rows, as a state without the
    key restores): each one's posterior means and deviations of a pool and
    its next picks against the live searcher's, bitwise.  Only the restore
    with the capacity must agree; the other shows whether the capacity
    reaches the card's results."""
    import copy
    import pickle

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import BayesOpt
    from repro_torch.launch.explore import generation_space

    space = generation_space(get_arch(ARCH), 8)

    def objective(c):
        x = space.encode(c)
        return np.array([1.0 + x[0] + 0.5 * x[3], 2.0 - x[1] + 0.3 * x[4]])

    def mk():
        return BayesOpt(space, seed=0, n_init=6, pool_size=128, gp_mode="cuda",
                        device=GP_DEVICE)

    live = mk()
    for size in (6, 5, 5, 5, 5, 5):
        for c in live.ask(size):
            live.tell(c, objective(c))
    asked = live.ask(5)
    state = pickle.loads(pickle.dumps(live.state_dict()))
    legacy = copy.deepcopy(state)
    del legacy["attrs"]["_gp_state"]["cap"]
    pool = np.stack([space.encode(c)
                     for c in space.sample_batch(np.random.default_rng(1), 256)])
    ys = np.stack(live.history_y)
    searchers = {"live": live}
    for label, st in (("with_cap", state), ("without_cap", legacy)):
        searchers[label] = mk()
        searchers[label].load_state(st)
    out = {}
    for label, s in searchers.items():
        gp = s._gp
        mu, sig = gp.fit_y_multi(ys).predict_multi(pool)
        for c in asked:
            s.tell(c, objective(c))
        out[label] = {"n": gp._n, "cap": gp._cap, "mu": mu, "sig": sig, "picks": s.ask(5)}
    want = out["live"]
    report = {}
    for label in ("with_cap", "without_cap"):
        got = out[label]
        report[label] = {"n": got["n"], "cap": got["cap"],
                         "max_abs_diff": float(max(np.abs(got["mu"] - want["mu"]).max(),
                                                   np.abs(got["sig"] - want["sig"]).max())),
                         "bitwise": bool(np.array_equal(got["mu"], want["mu"])
                                         and np.array_equal(got["sig"], want["sig"])),
                         "same_picks": got["picks"] == want["picks"]}
    emit("capacity_probe", live_n=want["n"], live_cap=want["cap"], **report)
    if not (report["with_cap"]["bitwise"] and report["with_cap"]["same_picks"]):
        raise AssertionError(f"capacity_probe: a restore at the snapshot's capacity "
                             f"differs from the live searcher: {report}")
    return report


def phase_explore_durable(explored, tmp):
    """The paper's command as given, ``--gp cuda --clients 1 --samples 200
    --checkpoint-dir D`` on explore_main's build cache, crashed by
    ``--chaos-crash-at`` in a subprocess (exit code 42) at each of
    ``DURABLE_CRASHES`` and resumed in a fresh process (``--resume``,
    exit code 0) that counts and records the GP kernels: 200 rows, ids
    0-199 once each, every row bit-identical (``float.hex``) to
    explore_parity's uninterrupted ParEGO ``--gp cuda`` CSV."""
    t_phase = time.perf_counter()
    want = hexed(sweep_columns(explored["parego_cuda"]))
    probe = capacity_probe()
    for crash_at in DURABLE_CRASHES:
        out = os.path.join(tmp, f"durable_{crash_at}.csv")
        argv = EXPLORE_CMD + ["--gp", "cuda", "--clients", "1",
                              "--samples", str(EXPLORE_SAMPLES), "--cache-dir", explored["cache"],
                              "--checkpoint-dir", os.path.join(tmp, f"durable_{crash_at}"),
                              "--out", out]
        t0 = time.perf_counter()
        crash = subprocess.run([sys.executable, "-m", "repro_torch.launch.explore", *argv,
                                "--chaos-crash-at", str(crash_at)], env=port_env(), cwd=REPO,
                               capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        crash_s = time.perf_counter() - t0
        if crash.returncode != CRASH_EXIT:
            raise AssertionError(f"explore_durable: the crash at {crash_at} exited "
                                 f"{crash.returncode}, not {CRASH_EXIT}:\n"
                                 f"{crash.stdout[-3000:]}{crash.stderr[-3000:]}")
        rows_at_crash = len(csv_ids(out))
        t0 = time.perf_counter()
        resumed = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-child",
                                  json.dumps(argv + ["--resume"])], env=port_env(), cwd=REPO,
                                 capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        resume_s = time.perf_counter() - t0
        if resumed.returncode != 0:
            raise AssertionError(f"explore_durable: the resume after {crash_at} exited "
                                 f"{resumed.returncode}:\n{resumed.stdout[-3000:]}"
                                 f"{resumed.stderr[-3000:]}")
        child = json.loads(resumed.stdout.strip().splitlines()[-1])["resume_child"]
        ids = csv_ids(out)
        got = hexed(sweep_columns(out))
        same = sum(got.get(i) == row for i, row in want.items())
        launches, replay = child["launches"], child["replay"]
        emit("explore_durable", crash_at=crash_at, crash_exit=crash.returncode,
             crash_seconds=crash_s, rows_at_crash=rows_at_crash, resume_exit=resumed.returncode,
             resume_seconds=resume_s, replay={k: replay.get(k) for k in
                                              ("n_events", "n_late_tells", "n_ask_mismatch",
                                               "from_snapshot", "outstanding", "next_id")},
             rows=len(ids), distinct_ids=len(set(ids)), identical_rows=same,
             launches=launches, launches_by_form=child["launches_by_form"],
             resume_timings=child["timings"])
        if sorted(ids) != list(range(EXPLORE_SAMPLES)):
            raise AssertionError(f"explore_durable {crash_at}: {len(ids)} rows, "
                                 f"{len(set(ids))} distinct ids; want 0..{EXPLORE_SAMPLES - 1} "
                                 f"once each")
        if got != want:
            raise AssertionError(f"explore_durable {crash_at}: {same} of {len(want)} rows "
                                 f"bit-identical to the uninterrupted --gp cuda sweep")
        if min(launches["gp_w"], launches["gp_g"]) == 0:
            raise AssertionError(f"explore_durable {crash_at}: the resumed process launched "
                                 f"no K1a/K1b: {launches}")
        if replay.get("from_snapshot") is not (crash_at > EXPLORE_CHECKPOINT_EVERY):
            raise AssertionError(f"explore_durable {crash_at}: replay {replay}")
    emit("explore_durable_phase", wall_seconds=time.perf_counter() - t_phase,
         capacity_probe=probe)
    print(nvidia_smi_line(), flush=True)


def serve_rows(out_dir, tenants):
    return {t["name"]: sweep_columns(os.path.join(out_dir, t["name"] + ".csv")) for t in tenants}


def counted_serve(argv, record=None):
    """``launch.serve_explore.main(argv)`` with the GP kernels' counts set
    to 0 just before and read just after; they must equal the sum of the
    GP tenants' own counters.  With ``record``, every K1a/K1b/K2 call of
    the run is kept there."""
    from repro_torch.kernels import gp_ops
    from repro_torch.launch import serve_explore

    kernels = (gp_ops.gp_w, gp_ops.gp_g, gp_ops.gp_ehvi)
    for k in kernels:
        k.launches = 0
    if record is not None:
        for k in kernels:
            setattr(gp_ops, k.__name__, Recorder(k, record))
    try:
        served = serve_explore.main(argv)
    finally:
        for k in kernels:
            setattr(gp_ops, k.__name__, k)
    launches = {k.__name__: k.launches for k in kernels}
    # ---- end of the counted run
    per_tenant = {}
    for name, sweep in served.service._sweeps.items():
        gp = getattr(sweep.search, "_gp", None)
        stats = gp.stats() if hasattr(gp, "stats") else {}
        per_tenant[name] = {"gp_w": stats.get("cuda_appends", 0),
                            "gp_g": stats.get("cuda_appends", 0),
                            "gp_ehvi": stats.get("cuda_scores", 0)}
    want = {k: sum(t[k] for t in per_tenant.values()) for k in launches}
    if launches != want:
        raise AssertionError(f"serve_explore {argv}: GP kernel launches {launches} do not "
                             f"match the tenants' GP counters {per_tenant}")
    return served, launches, per_tenant


def phase_serve_explore_main(explored, tmp):
    """``python -m repro_torch.launch.serve_explore --workload llama2-7b
    --clients 2 --fleet-cache serve --tenants T.json --checkpoint-root R`` on
    a fresh cache directory, three tenants (``SERVE_TENANTS``): each
    tenant's ids 0..n-1 once each; every row's metrics equal to the same
    knobs' in explore_main's CSVs where they appear there, and to a
    re-evaluation on explore_main's builds for every row; fleet-wide builds
    equal to the distinct sw fingerprints touched; K1a/K1b launched for the
    GP tenants, every recorded call held against its plain version.  Then
    the same tenants at one client under ``--gp cuda`` and ``--gp
    incremental`` must give each tenant the same rows."""
    from repro_torch.core import JClient, JConfig, TestConfig
    from repro_torch.configs import get_arch
    from repro_torch.launch import explore

    t_phase = time.perf_counter()
    spec = os.path.join(tmp, "tenants.json")
    with open(spec, "w") as f:
        json.dump(SERVE_TENANTS, f)
    out = os.path.join(tmp, "serve_main")
    argv = ["--workload", ARCH, "--tenants", spec, "--clients", "2", "--fleet-cache", "serve",
                   "--checkpoint-root", os.path.join(tmp, "serve_ck"), "--out-dir", out,
                   "--cache-dir", os.path.join(tmp, "serve_cache")]
    calls = []
    served, launches, per_tenant = counted_serve(argv, record=calls)
    rows = serve_rows(out, SERVE_TENANTS)
    for t in SERVE_TENANTS:
        ids = csv_ids(os.path.join(out, t["name"] + ".csv"))
        if sorted(ids) != list(range(t["samples"])):
            raise AssertionError(f"serve_explore_main {t['name']}: ids {sorted(ids)[:5]}... "
                                 f"({len(ids)} rows, {len(set(ids))} distinct); want "
                                 f"0..{t['samples'] - 1} once each")
        if any(r.status != "ok" for r in served.service._sweeps[t["name"]].store.records):
            raise AssertionError(f"serve_explore_main {t['name']}: a row is not ok")
    # the same knobs' metrics: explore_main's CSVs, and a re-evaluation on
    # its builds (disk hits in explore_parity's one-client cache)
    known = {}
    for path in explored["csvs"]:
        for r in sweep_columns(path).values():
            knobs = tuple(sorted((k, v) for k, v in r.items() if k.startswith("knob.")))
            known[knobs] = {k: v for k, v in r.items() if k.startswith("metric.")}
    args = explore.parse_args(EXPLORE_CMD)
    space = explore.generation_space(get_arch(ARCH), args.chips)
    jc = JConfig(space, n_chips=args.chips)
    judge = JClient(jc, explore.make_build_fn(args, jc),
                    cache_dir=os.path.join(explored["cache"], "client0"))
    in_csv = reevaluated = 0
    fps = set()
    for name, sweep in served.service._sweeps.items():
        for rec in sweep.store.records:
            tc = TestConfig(rec.config_id, ARCH, "generate", rec.knobs)
            fps.add(jc.cache_key(tc))
            row = {f"metric.{k}": v for k, v in rec.metrics.items()}
            csv_row = rows[name][rec.config_id]
            knobs = tuple(sorted((k, v) for k, v in csv_row.items() if k.startswith("knob.")))
            if knobs in known:
                in_csv += 1
                if hexed({0: known[knobs]}) != hexed({0: {k: csv_row[k] for k in known[knobs]}}):
                    raise AssertionError(f"serve_explore_main {name} {rec.config_id}: metrics "
                                         f"{csv_row} differ from explore_main's {known[knobs]}")
            again = judge.evaluate(tc)
            reevaluated += 1
            if {k: float_hex(v) for k, v in again["metrics"].items()} != \
                    {k[7:]: float_hex(v) for k, v in row.items()}:
                raise AssertionError(f"serve_explore_main {name} {rec.config_id}: metrics "
                                     f"{rec.metrics} differ from a re-evaluation "
                                     f"{again['metrics']}")
    builds = sum(c.n_compiled for c in served.clients)
    gp_tenants = [t["name"] for t in SERVE_TENANTS if t.get("gp") == "cuda"]
    emit("serve_explore_main", argv=argv, wall_seconds=served.wall_s,
         evals=sum(len(s.store.records) for s in served.service._sweeps.values()),
         builds=builds, fingerprints=len(fps), fleet=served.fleet_stats,
         client_cache=[c.cache_info() for c in served.clients], launches=launches,
         per_tenant_launches=per_tenant, rows_in_explore_main_csvs=in_csv,
         rows_reevaluated=reevaluated, judge_builds=judge.n_compiled,
         tenants={n: {"state": s.state, "completed": s.completed}
                  for n, s in served.service._sweeps.items()})
    if builds != len(fps):
        raise AssertionError(f"serve_explore_main: {builds} builds for {len(fps)} sw "
                             f"fingerprints (the fleet store must build each once)")
    for name in gp_tenants:
        if min(per_tenant[name]["gp_w"], per_tenant[name]["gp_g"]) == 0:
            raise AssertionError(f"serve_explore_main: tenant {name} launched no K1a/K1b: "
                                 f"{per_tenant}")
    check_recorded(calls, "serve_explore_main")
    cols = {}
    for gp in ("cuda", "incremental"):
        out1 = os.path.join(tmp, f"serve_one_{gp}")
        spec1 = os.path.join(tmp, f"tenants_{gp}.json")
        with open(spec1, "w") as f:      # the GP tenants on this tier
            json.dump([dict(t, gp=gp) if "gp" in t else t for t in SERVE_TENANTS], f)
        served1, launches1, _ = counted_serve(
            ["--workload", ARCH, "--tenants", spec1, "--clients", "1", "--gp", gp,
             "--fleet-cache", "serve", "--checkpoint-root", os.path.join(tmp, f"serve_ck_{gp}"),
             "--out-dir", out1, "--cache-dir", explored["cache"]])
        cols[gp] = serve_rows(out1, SERVE_TENANTS)
        emit("serve_explore_parity", gp=gp, wall_seconds=served1.wall_s, launches=launches1,
             builds=sum(c.n_compiled for c in served1.clients))
        if (min(launches1["gp_w"], launches1["gp_g"]) > 0) != (gp == "cuda"):
            raise AssertionError(f"serve_explore_parity --gp {gp}: GP kernel launches "
                                 f"{launches1}")
    same = {n: sum(cols["cuda"][n].get(i) == r for i, r in cols["incremental"][n].items())
            for n in cols["incremental"]}
    emit("serve_explore_parity", identical_rows=same,
         rows={n: len(r) for n, r in cols["incremental"].items()})
    if cols["cuda"] != cols["incremental"]:
        raise AssertionError(f"serve_explore_parity: --gp cuda and --gp incremental tenants "
                             f"differ ({same} identical rows)")
    emit("serve_explore_phase", wall_seconds=time.perf_counter() - t_phase)
    print(nvidia_smi_line(), flush=True)


def gp_bound(kernel, cap, n, width, d, S=0, exp_f64=0):
    """(bound_ms, bound_by): K1a/K1b read the active lower triangle of L⁻¹
    and do 2 flop per (row, active column, B column) of it.  K2 reads the
    pool, the active rows and weights and the staircase; per (candidate,
    row) pair it does the 2d-flop contraction, at the float64 tensor rate,
    and on the CUDA cores one exp() (``exp_f64`` float64 instructions, as
    counted in its SASS) and 7 more (the d² form 2, the clamp, the two
    scalings, the two means' multiply-adds), each an issue of 2 flop at
    34 TFLOP/s, plus 5 flop per (candidate, segment).  Bytes over
    3.35 TB/s, operations over those peaks."""
    tri = n * (n + 1) // 2
    if kernel == "gp_w":
        nbytes, flops = 8 * (tri + n * d + width * d + cap * width), 2 * tri * width + n * width * (2 * d + 9)
    elif kernel == "gp_g":
        nbytes, flops = 8 * (tri + n * width + width * cap), 2 * tri * width
    else:
        nbytes = 8 * (width * d + n * d + 2 * n + 3 * S + 4 + width)
        pairs = width * n
        t_ops = (2 * d * pairs / PEAK_FLOPS["float64"]
                 + (2 * (exp_f64 + 7) * pairs + 5 * width * S) / F64_CUDA_CORE_FLOPS)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float64"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_gp_times(errs, launches, exp_f64):
    """Times of K1a, K1b and K2 at the search path's shapes (cap 8192,
    n = 6250, d = 14; B = 512 for a fold and 1 for a timed tell; P = 512),
    beside their plain versions, K1b's library product, and the torch
    tier's whole append and scoring."""
    import torch

    from repro_torch.core.search import gp_torch
    from repro_torch.kernels import gp_ops

    cap, n, d = SEARCH_CAP, SEARCH_N, SEARCH_D
    rows = {}
    for m in (512, 1):
        ls, xb, lb, lib, xnew, ls2, _, xs, xq = gp_state(cap, n, m, d, False, GP_SEED)
        w = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        # K1a's product alone as one library call on a precomputed K12:
        # context, not a yardstick (building K12 is a second call)
        k12 = gp_ops.tile_kern(xs, xq, ls2, 1.0)
        k12[n:] = 0.0
        k12[:, m:] = 0.0
        iters = 20 if m > 1 else 100
        fns = {
            "gp_w": (lambda: gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0),
                     lambda: gp_ops.gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=1.0), None),
            "gp_g": (lambda: gp_ops.gp_g(w, lib, n), lambda: gp_ops.gp_g_plain(w, lib, n),
                     lambda: torch.matmul(w.T, lib)),
        }
        for name, (kernel, plain, library) in fns.items():
            bound_ms, bound_by = gp_bound(name, cap, n, m, d)
            row = dict(ms=cuda_ms(kernel, iters), plain_ms=cuda_ms(plain, iters),
                       library_ms=None if library is None else cuda_ms(library, iters),
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
                       **device_times(kernel=kernel, plain=plain))
            # the kernels one call launches (K12, product, fix-up), by name:
            # profiler device time per call and events recorded per call
            row["kernel_by_name"] = [{k: r[k] for k in ("name", "ms", "calls", "ms_per_event")}
                                     for r in profile(kernel, calls=10)["top"]]
            if name == "gp_w":
                row["context_matmul_lib_k12_ms"] = cuda_ms(lambda: torch.matmul(lib, k12), iters)
            rows[(name, m)] = row
            emit("time", kernel=name, cap=cap, n=n, B=xnew.shape[0], d=d,
                 tiles=gp_ops.tiles(xnew.shape[0], cap, n), **row)
        # whole appends, each tier on its own copy of the state; rows >= n
        # are zeroed after every call so each call appends to the same state
        tiers = {}
        for tier in ("cuda", "torch"):
            bufs = [xb.clone(), lb.clone(), lib.clone()]

            def append(bufs=bufs, tier=tier):
                if tier == "cuda":
                    gp_ops.gp_append(*bufs, n, m, xnew, None, GP_NOISE, ls2=ls2, signal=1.0)
                else:
                    gp_torch._append(*bufs, n, m, xnew, ls, GP_NOISE, 1.0)
                bufs[1][n:] = 0.0
                bufs[2][n:] = 0.0
            tiers[f"{tier}_append_ms"] = cuda_ms(append, 10)
            del bufs
        emit("time", step="append", cap=cap, n=n, B=xnew.shape[0], d=d, **tiers)
        rows[("append", m)] = tiers
        del xb, lb, lib, w, k12
        torch.cuda.empty_cache()

    c = ehvi_case(cap, n, 512, d, 12, False, GP_SEED)
    args = (c["xqs"], c["xs"], c["alpha"], n, c["stair"], c["ymd"])
    ym, ysd = c["ymd"][0], c["ymd"][1]

    def kernel():
        return gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)

    def plain():
        return gp_ops.gp_ehvi_plain(*args, ls2=c["ls2"], signal=1.0)

    def torch_tier():
        return gp_torch._ehvi(c["xb"], c["alpha"], n, c["xq"], c["fpad"], c["ref"],
                              ym, ysd, c["ls"], 1.0)
    if (torch_tier() - kernel()).abs().max().item() > EHVI_TOL:
        raise AssertionError("K2 and the torch tier's EHVI disagree on the timing inputs")
    bound_ms, bound_by = gp_bound("gp_ehvi", cap, n, 512, d, c["S"], exp_f64)
    row = dict(
        ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 200), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, torch_tier_ms=cuda_ms(torch_tier, 200),
        kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
        **device_times(kernel=kernel, plain=plain, torch_tier=torch_tier))
    row["kernel_by_name"] = [{k: r[k] for k in ("name", "ms", "calls", "ms_per_event")}
                             for r in profile(kernel, calls=10)["top"]]
    rows[("gp_ehvi", 512)] = row
    tiles, runs = gp_ops.ehvi_split(n, 512, gp_ops.sm_count(torch.cuda.current_device()))
    emit("time", kernel="gp_ehvi", cap=cap, n=n, P=512, d=d, S=c["S"], grid=[tiles, len(runs)],
         splits=len(runs), rows_per_split=[hi - lo for lo, hi in runs[:2]],
         exp_f64_instructions=exp_f64, **row)

    emit("gp_tiles", fold=gp_ops.tiles(512, cap, n), tell=gp_ops.tiles(1, cap, n),
         ehvi_grid=[tiles, len(runs)],
         smem_bytes_d14={"gp_w_tell": gp_ops.smem_bytes("gp_w", d),
                         "gp_w_fold": gp_ops.smem_bytes("gp_w", d, fold=True),
                         "gp_ehvi": gp_ops.smem_bytes("gp_ehvi", d)})
    out = []
    for name, line, width in (("gp_w", 76, 512), ("gp_g", 111, 512), ("gp_ehvi", 224, 512)):
        r = rows[(name, width)]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/gp_ops.cu",
                    "replaces": f"src/repro/kernels/gp_ops.py:{line}",
                    "launches": launches[name], "max_abs_err": errs[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def run_only(names, infos):
    """``--only a,b``: the build, then only the named phases (for iterating
    on one phase; prints no result line)."""
    phases = {
        "k3_sass": lambda: phase_k3_sass(infos["flash_attention"]),
        "ssd_sass": lambda: phase_ssd_sass(infos["ssd_scan"]),
        "parity": phase_parity, "ssd_parity": phase_ssd_parity, "topk_parity": phase_topk_parity,
        "main_path": lambda: phase_main_path(N_LAYERS, SEED),
        "main_ssm": lambda: phase_ssm_main(SEED), "main_moe": lambda: phase_moe_main(SEED),
        "frontends_main": lambda: phase_frontends_main(SEED),
        "train_main": lambda: phase_train_main(tempfile.mkdtemp(prefix="train")),
        "train_moe": lambda: phase_train_moe(SEED),
        "explore_llava": lambda: phase_explore_llava(tempfile.mkdtemp(prefix="llava")),
        "explore_train": lambda: phase_explore_train(tempfile.mkdtemp(prefix="xtrain")),
        "train_sharded": lambda: phase_train_sharded(SEED, tempfile.mkdtemp(prefix="shard")),
        "sharded_ssm": lambda: phase_sharded_ssm(SEED),
        "fp32_times": phase_fp32_times,
        "decode_times": phase_decode_times,
        "serve_fp32": lambda: phase_serve_fp32(SEED),
        "examples": lambda: phase_examples(tempfile.mkdtemp(prefix="examples")),
    }
    for name in names:
        t0 = time.perf_counter()
        phases[name]()
        emit("only", ran=name, seconds=time.perf_counter() - t0)
    return 0


def main(only=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_script = time.perf_counter()
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    probe_build = start_probe_build()
    infos = build.build_all(["flash_attention", "gp_ops", "ssd_scan", "topk_gating",
                             "decode_attention"], force=True)
    probe = finish_probe_build(probe_build)
    emit("build", wall_seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": i.seconds, "library": str(i.path.relative_to(REPO))}
                  for n, i in infos.items()})
    for name, info in infos.items():
        print(f"[build] {name} -Xptxas -v:\n{info.log.strip()}", flush=True)
    if only:
        return run_only(only, infos)
    phase_k3_sass(infos["flash_attention"])
    exp_f64 = phase_gp_sass(infos["gp_ops"], probe)
    phase_ssd_sass(infos["ssd_scan"])

    errs = phase_parity()
    ssd_errs = phase_ssd_parity()
    topk_err = phase_topk_parity()
    launches = phase_main_path(N_LAYERS, SEED)
    phase_two_layer_gap(SEED)
    phase_small_reference()
    ssm_launches = phase_ssm_main(SEED)
    moe_launches = phase_moe_main(SEED)
    serve_fp32 = phase_serve_fp32(SEED)
    frontend_launches = phase_frontends_main(SEED)
    gp_errs = phase_gp_parity()
    phase_search_small()
    gp_launches = phase_search_main()
    with tempfile.TemporaryDirectory(prefix="explore") as tmp:
        explored = phase_explore_main(tmp)
        phase_explore_durable(explored, tmp)
        phase_serve_explore_main(explored, tmp)
        phase_explore_llava(tmp)
        train_launches = phase_train_main(tmp)
        train_gp = phase_explore_train(tmp)
        sharded = phase_train_sharded(SEED, tmp)
        sharded_ssm = phase_sharded_ssm(SEED)
        examples_k5 = phase_examples(tmp)
    kernels = (phase_times(errs, launches) + phase_gp_times(gp_errs, gp_launches, exp_f64)
               + phase_new_times(ssd_errs, topk_err, ssm_launches, moe_launches, probe)
               + phase_decode_times({ARCH: launches["decode_attention"],
                                     MOE_ARCH: moe_launches["decode_attention"]})
               + phase_fp32_times(
                   {"flash_attention_fp32": errs["engine_prefill_fp32"],
                    "ssd_scan_fp32": ssd_errs["engine_prefill_fp32"]},
                   {"flash_attention_fp32": serve_fp32[ARCH]["flash_attention"],
                    "ssd_scan_fp32": serve_fp32[SSM_ARCH]["ssd_scan"]}))
    paths = {"flash_attention": {ARCH: launches["flash_attention"],
                                 MOE_ARCH: moe_launches["flash_attention"], **frontend_launches},
             "flash_attention_fp32": {
                 f"{ARCH} serve_fp32": serve_fp32[ARCH]["flash_attention"],
                 f"{ARCH} sharded prefill ({SHARDED_PREFILL_LAYERS} layers)":
                     sharded["flash_attention"],
                 f"{ARCH} sharded prefill (sp)": sharded["flash_attention_sp"]},
             "ssd_scan": {f"{SSM_ARCH} serving": ssm_launches["ssd_scan"]},
             "ssd_scan_fp32": {f"{SSM_ARCH} serve_fp32": serve_fp32[SSM_ARCH]["ssd_scan"],
                               f"{SSM_ARCH} sharded prefill (sp)": sharded_ssm},
             "topk_gating": {f"{MOE_ARCH} serving": moe_launches["topk_gating"],
                             f"{MOE_ARCH} training ({MOE_TRAIN_LAYERS} layers)":
                                 train_launches["topk_gating"],
                             f"{MOE_ARCH} sharded training ({MOE_TRAIN_LAYERS} layers, "
                             f"{SHARDED_STEPS} steps)": sharded["topk_gating"],
                             "examples serve_batched": examples_k5}}
    for name in ("gp_w", "gp_g", "gp_ehvi"):
        paths[name] = {f"explore_train {strategy}": train_gp[strategy][name]
                       for strategy in train_gp}
    for k in kernels:
        if k["name"] in paths:
            k["launches_by_path"] = paths[k["name"]]
    emit("script", seconds=time.perf_counter() - t_script)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:       # explore_durable's resumed process
        sys.exit(resume_child(sys.argv[2]))
    if sys.argv[1:2] == ["--only"]:               # e.g. --only frontends_main,train_main
        sys.exit(main(only=sys.argv[2].split(",")))
    sys.exit(main())
