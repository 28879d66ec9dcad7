"""The port's serving slice against the JAX package, on the CPU at reduced size.

Weights come from the JAX ``Model.init`` and are carried across with
``repro_torch.models.convert``; token inputs come from numpy.  Everything
runs in float32, at ``tests/test_prefill_decode.py``'s tolerance (5e-5).
The ``flash`` path takes K3's plain version on the CPU on the port's side
and the Pallas kernel in interpret mode on the JAX side.
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

TOL = dict(atol=5e-5, rtol=5e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, attn_impl="xla", seed=0, **overrides):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = jreduced(jget_arch(name), **overrides)
    jm = JModel(jcfg, JFlags(dtype="float32", remat="none", sp=False,
                             attn_impl=attn_impl))
    params = jm.init(jax.random.key(seed))
    cfg = reduced(get_arch(name), **overrides)
    tm = Model(cfg, BuildFlags(dtype="float32", attn_impl=attn_impl),
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


@pytest.mark.parametrize("name", ["mamba2-780m", "deepseek-moe-16b", "llava-v1.5-7b"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(reduced(get_arch(name)), device="cpu")
