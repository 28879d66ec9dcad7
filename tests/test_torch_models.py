"""The port's serving slice against the JAX package, on the CPU at reduced size.

Weights come from the JAX ``Model.init`` and are carried across with
``repro_torch.models.convert``; token inputs come from numpy.  Everything
runs in float32, at ``tests/test_prefill_decode.py``'s tolerance (5e-5).
The ``flash`` path takes K3's plain version on the CPU on the port's side
and the Pallas kernel in interpret mode on the JAX side; so does the
``cuda`` SSD path (K4's plain version) against the reference's ``pallas``.
The Mamba-2, MoE and hybrid families (mamba2-780m, deepseek-moe-16b,
jamba-v0.1-52b) are held for both SSD paths: prefill logits and every cache
leaf, one decode step, ``Engine`` tokens and ``SlotServer`` outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import BuildFlags as JFlags, Model as JModel
from repro.models import attention as jattn
from repro.serve import Engine as JEngine
from repro.serve.kv_cache import SlotServer as JSlotServer
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import BuildFlags, Model
from repro_torch.models import attention
from repro_torch.models.convert import caches_from_jax, flatten, params_from_jax, to_tensor
from repro_torch.serve import Engine, SlotServer
from repro_torch.serve.engine import pad_caches

TOL = dict(atol=5e-5, rtol=5e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# (port ssd_impl, reference ssd_impl)
SSD_IMPLS = [("jnp", "jnp"), ("cuda", "pallas")]
NEW_FAMILIES = ["mamba2-780m", "deepseek-moe-16b", "jamba-v0.1-52b"]


def _pair(name, attn_impl="xla", seed=0, ssd=("jnp", "jnp"), **overrides):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = jreduced(jget_arch(name), **overrides)
    jm = JModel(jcfg, JFlags(dtype="float32", remat="none", sp=False,
                             attn_impl=attn_impl, ssd_impl=ssd[1]))
    params = jm.init(jax.random.key(seed))
    cfg = reduced(get_arch(name), **overrides)
    tm = Model(cfg, BuildFlags(dtype="float32", attn_impl=attn_impl, ssd_impl=ssd[0]),
               device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(_np_tree(params), cfg))
    return jm, params, tm


def _attn_pair(seed=0):
    jcfg = jreduced(jget_arch("tinyllama-1.1b"))
    cfg = reduced(get_arch("tinyllama-1.1b"))
    p = jattn.attn_init(jax.random.key(seed), jcfg, jnp.float32)
    mod = attention.Attention(cfg, torch.float32, "cpu")
    mod.load_state_dict({n: to_tensor(v) for n, v in flatten(_np_tree(p))})
    return jcfg, cfg, p, mod


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [0, 8])
def test_full_attention_matches_reference(impl, window):
    jcfg, cfg, p, mod = _attn_pair()
    x = np.random.default_rng(0).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want, wcache = jattn.full_attention(p, jnp.asarray(x), jcfg, window=window,
                                        impl=impl, attn_block_q=16, attn_block_kv=16)
    got, cache = attention.full_attention(mod, torch.from_numpy(x), cfg, window=window,
                                          impl=impl, attn_block_q=16, attn_block_kv=16)
    _close(got, want)
    _close(cache["k"], wcache["k"])
    _close(cache["v"], wcache["v"])


@pytest.mark.parametrize("pos", [5, (2, 7, 11)], ids=["aligned", "per_slot"])
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_reference(pos, window):
    jcfg, cfg, p, mod = _attn_pair(1)
    rng = np.random.default_rng(1)
    b, s_max = 3, 12
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    shp = (b, s_max, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": rng.standard_normal(shp).astype(np.float32),
             "v": rng.standard_normal(shp).astype(np.float32)}
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos) if isinstance(pos, tuple) else pos
    want, wcache = jattn.decode_attention(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()}, jpos, jcfg,
        window=window)
    got, gcache = attention.decode_attention(
        mod, torch.from_numpy(x), {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
        tpos, cfg, window=window)
    _close(got, want)
    _close(gcache["k"], wcache["k"])
    _close(gcache["v"], wcache["v"])


@pytest.mark.parametrize("name", ["llama2-7b", "tinyllama-1.1b", "gemma3-27b"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_reference(name, impl):
    jm, params, tm = _pair(name, impl, seed=1)
    b, s = 2, 16
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (b, s + 1)).astype(np.int32)

    wlogits, wcaches = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.inference_mode():
        logits, caches = tm.prefill({"tokens": toks[:, :s]})
    _close(logits, wlogits)
    for got, want in zip(caches, caches_from_jax(_np_tree(wcaches), tm.cfg)):
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])

    # one decode step at position s against caches grown by one slot
    pad = lambda c: jnp.pad(c, [(0, 0)] * (c.ndim - 3) + [(0, 1), (0, 0), (0, 0)])
    wdec, wcaches = jm.decode_step(params, jnp.asarray(toks[:, s:]),
                                   jax.tree.map(pad, wcaches), s)
    with torch.inference_mode():
        grown = [{n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for n, c in l.items()}
                 for l in caches]
        dec, caches = tm.decode_step(toks[:, s:], grown, s)
    _close(dec, wdec)
    for got, want in zip(caches, caches_from_jax(_np_tree(wcaches), tm.cfg)):
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])


def test_tied_embeddings_prefill_matches_reference():
    """No registered arch ties embeddings; the port's _logits branch for it
    and the converter's missing ``head`` are held here."""
    jm, params, tm = _pair("llama2-7b", tie_embeddings=True)
    assert "head" not in params and not hasattr(tm, "head")
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    want, _ = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = tm.prefill({"tokens": toks})
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_generate_matches_reference(impl):
    jm, params, tm = _pair("llama2-7b", impl, seed=3)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JEngine(jm, params, max_len=16, donate=False).generate(
        {"tokens": jnp.asarray(toks)}, 6)
    launches = fa.flash_attention.launches
    got = Engine(tm, max_len=16).generate({"tokens": toks}, 6)
    assert fa.flash_attention.launches == launches   # the CPU takes the plain version
    assert (got.n_prompt, got.n_generated) == (want.n_prompt, want.n_generated)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_slot_server_matches_engine_and_reference():
    """The pattern of tests/test_slot_server.py: 3 requests over 2 slots."""
    jm, params, tm = _pair("tinyllama-1.1b", "xla", seed=0)
    rng = np.random.default_rng(0)
    max_len = 48
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    new_counts = [6, 4, 8]

    def run(srv):
        for i, (p, n) in enumerate(zip(prompts, new_counts)):
            srv.submit(i, p, n)
        finished = srv.run()
        assert len(finished) == 3
        return {r.rid: r.out for r in finished}

    got = run(SlotServer(tm, n_slots=2, max_len=max_len))
    want = run(JSlotServer(jm, params, n_slots=2, max_len=max_len))
    assert got == want
    for i, (p, n) in enumerate(zip(prompts, new_counts)):
        solo = Engine(tm, max_len=max_len).generate({"tokens": p[None, :]}, n)
        assert got[i] == solo.tokens[0].tolist()


def _close_caches(caches, wcaches, cfg):
    want = caches_from_jax(_np_tree(wcaches), cfg)
    assert len(caches) == len(want)
    for got, w in zip(caches, want):
        assert sorted(got) == sorted(w)
        for name in got:
            assert got[name].shape == w[name].shape, name
            _close(got[name], w[name])


@pytest.mark.parametrize("ssd", SSD_IMPLS, ids=["jnp", "cuda"])
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_prefill_and_decode_match_reference(name, ssd):
    jm, params, tm = _pair(name, seed=1, ssd=ssd)
    b, s = 2, 13                      # 13 positions: a ragged second SSD chunk
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (b, s + 1)).astype(np.int32)
    wlogits, wcaches = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s])})
    with torch.inference_mode():
        logits, caches = tm.prefill({"tokens": toks[:, :s]})
    _close(logits, wlogits)
    _close_caches(caches, wcaches, tm.cfg)

    # one decode step at position s, the K/V grown by one slot as each engine does
    wgrown = JEngine(jm, params, max_len=s + 1, donate=False)._pad_caches(wcaches, s)
    wdec, wcaches = jm.decode_step(params, jnp.asarray(toks[:, s:]), wgrown, s)
    with torch.inference_mode():
        dec, caches = tm.decode_step(toks[:, s:], pad_caches(caches, s, s + 1), s)
    _close(dec, wdec)
    _close_caches(caches, wcaches, tm.cfg)


@pytest.mark.parametrize("ssd", SSD_IMPLS, ids=["jnp", "cuda"])
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_engine_matches_reference(name, ssd):
    """An 11-token prompt: at a prompt length equal to the SSM head count (8
    at reduced size) the reference's shape test pads the Mamba state as if
    it were K/V and fails; ``test_engine_pads_only_kv`` covers that length."""
    jm, params, tm = _pair(name, seed=3, ssd=ssd)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    want = JEngine(jm, params, max_len=20, donate=False).generate(
        {"tokens": jnp.asarray(toks)}, 6)
    got = Engine(tm, max_len=20).generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_engine_pads_only_kv():
    """A prompt as long as the SSM head count: the Engine grows the K/V only
    and leaves the Mamba state and conv as prefill returned them, so its
    tokens equal a SlotServer's, which is held against the reference above."""
    _, _, tm = _pair("jamba-v0.1-52b", seed=4)
    assert tm.cfg.n_ssm_heads == 8
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (1, 8)).astype(np.int32)
    with torch.inference_mode():
        _, caches = tm.prefill({"tokens": toks})
    grown = pad_caches(caches, 8, 20)
    for before, after in zip(caches, grown):
        for name, c in after.items():
            assert c.shape == (before[name].shape if name in ("state", "conv")
                               else (1, 20) + before[name].shape[2:])
    got = Engine(tm, max_len=20).generate({"tokens": toks}, 6)
    srv = SlotServer(tm, n_slots=2, max_len=20)
    srv.submit(0, toks[0], 6)
    assert got.tokens[0].tolist() == srv.run()[0].out


@pytest.mark.parametrize("ssd", SSD_IMPLS, ids=["jnp", "cuda"])
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_slot_server_matches_reference(name, ssd):
    """3 requests over 2 slots, a 9-token prompt across two SSD chunks.  The
    MoE families are held against the reference's SlotServer only: capacity
    drops depend on which tokens share a batch."""
    jm, params, tm = _pair(name, seed=0, ssd=ssd)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 7)]
    new_counts = [6, 4, 8]

    def run(srv):
        for i, (p, n) in enumerate(zip(prompts, new_counts)):
            srv.submit(i, p, n)
        return {r.rid: r.out for r in srv.run()}

    got = run(SlotServer(tm, n_slots=2, max_len=32))
    assert got == run(JSlotServer(jm, params, n_slots=2, max_len=32))
    assert all(len(got[i]) == n for i, n in enumerate(new_counts))


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_slot_server_prompts_shorter_than_the_conv_window(name):
    """Prompts of 1 and 2 tokens leave the slot's conv window (K-1 = 3 rows)
    part empty: the rows prefill gives are written and the rest zeroed, as
    the reference's SlotServer pads them."""
    jm, params, tm = _pair(name, seed=5)
    assert tm.cfg.ssm_conv - 1 == 3
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=n).astype(np.int32) for n in (1, 2, 4)]

    def run(srv):
        for i, p in enumerate(prompts):
            srv.submit(i, p, 5)
        return {r.rid: r.out for r in srv.run()}

    got = run(SlotServer(tm, n_slots=2, max_len=16))
    assert got == run(JSlotServer(jm, params, n_slots=2, max_len=16))
    assert all(len(out) == 5 for out in got.values())
