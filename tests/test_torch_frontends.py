"""The port's vision and audio frontends against the JAX package, on the CPU.

Reduced llava-v1.5-7b and internvl2-2b (vision: projected patch embeddings
ahead of the text) and musicgen-medium (audio: projected frame embeddings,
no text) take the JAX ``Model.init`` weights through ``params_from_jax``
(``frontend/proj`` included) and the same numpy inputs.  In fp32 at
``tests/test_prefill_decode.py``'s tolerance (5e-5): prefill logits and
every K/V cache leaf, a decode step, and for vision the ``Engine``'s
tokens, which must be equal.  The ``flash`` path takes K3's plain version
on the CPU and the Pallas kernel in interpret mode on the JAX side.  An
audio batch has no tokens to continue: the reference's ``Engine`` fails
on it with a ``KeyError`` and the port's refuses it with a ``ValueError``.
The meta build counts the frontend projection: its FLOPs equal the
analytic count of ``tests/test_torch_roofline.py`` plus 2·F·d² at full
width, and a LLaVA prompt shorter than its 576 image tokens fails in both
packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.launch.build import build_generation as jbuild_generation
from repro.launch.mesh import make_host_mesh
from repro.models import BuildFlags as JFlags, Model as JModel
from repro.serve import Engine as JEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import build, serve
from repro_torch.models import BuildFlags, Model
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serve import Engine
from repro_torch.serve.engine import pad_caches
from tests.test_torch_roofline import analytic_flops

TOL = dict(atol=5e-5, rtol=5e-5)
VISION = ["llava-v1.5-7b", "internvl2-2b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, impl="xla", seed=0):
    jcfg = jreduced(jget_arch(name))
    jm = JModel(jcfg, JFlags(dtype="float32", remat="none", sp=False, attn_impl=impl))
    params = jm.init(jax.random.key(seed))
    cfg = reduced(get_arch(name))
    tm = Model(cfg, BuildFlags(dtype="float32", attn_impl=impl), device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(_np(params), cfg))
    return jm, params, tm


def _batch(cfg, b, n, seed):
    """A vision batch (F image embeddings, n text tokens) or an audio batch
    (n frame embeddings), in numpy; and the next token of each row."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    else:
        batch["frame_embeds"] = rng.standard_normal((b, n, cfg.d_model), dtype=np.float32)
    return batch, rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _close_caches(caches, wcaches, cfg):
    want = caches_from_jax(_np(wcaches), cfg)
    assert len(caches) == len(want) == cfg.n_layers
    for got, w in zip(caches, want):
        for name in ("k", "v"):
            assert got[name].shape == w[name].shape
            _close(got[name], w[name])


def test_frontend_projection_carries_across():
    jm, params, tm = _pair("llava-v1.5-7b")
    assert tm.frontend.proj.shape == (tm.cfg.d_model, tm.cfg.d_model)
    np.testing.assert_array_equal(tm.frontend.proj.numpy(),
                                  np.asarray(params["frontend"]["proj"]))
    assert not hasattr(Model(reduced(get_arch("llama2-7b")), device="cpu"), "frontend")


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", VISION + ["musicgen-medium"])
def test_prefill_and_decode_match_reference(name, impl):
    """Prefill over the frontend embeddings (and the text), then one decode
    step at the next position against caches grown by one slot."""
    jm, params, tm = _pair(name, impl, seed=1)
    batch, nxt = _batch(tm.cfg, 2, 9, seed=2)
    wlogits, wcaches = jm.prefill(params, jax.tree.map(jnp.asarray, batch))
    before = fa.flash_attention.launches
    with torch.inference_mode():
        logits, caches = tm.prefill(batch)
    assert fa.flash_attention.launches == before       # the CPU takes the plain version
    _close(logits, wlogits)
    _close_caches(caches, wcaches, tm.cfg)

    s = caches[0]["k"].shape[1]
    assert s == 9 + (tm.cfg.n_frontend_tokens if tm.cfg.frontend == "vision" else 0)
    wgrown = JEngine(jm, params, max_len=s + 1, donate=False)._pad_caches(wcaches, s)
    wdec, wcaches = jm.decode_step(params, jnp.asarray(nxt), wgrown, s)
    with torch.inference_mode():
        dec, caches = tm.decode_step(nxt, pad_caches(caches, s, s + 1), s)
    _close(dec, wdec)
    _close_caches(caches, wcaches, tm.cfg)


@pytest.mark.parametrize("name", VISION)
def test_vision_prefill_equals_shorter_prefill_plus_decode(name):
    """tests/test_prefill_decode.py's check on the port: the last text
    token through a decode step gives the full prefill's logits."""
    _, _, tm = _pair(name, seed=3)
    batch, _ = _batch(tm.cfg, 2, 8, seed=3)
    s = tm.cfg.n_frontend_tokens + 8
    with torch.inference_mode():
        full, _ = tm.prefill(batch)
        _, caches = tm.prefill(dict(batch, tokens=batch["tokens"][:, :-1]))
        dec, _ = tm.decode_step(batch["tokens"][:, -1:], pad_caches(caches, s - 1, s), s - 1)
    _close(dec, full.numpy())


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", VISION)
def test_vision_engine_matches_reference(name, impl):
    jm, params, tm = _pair(name, impl, seed=4)
    batch, _ = _batch(tm.cfg, 2, 6, seed=4)
    want = JEngine(jm, params, max_len=24, donate=False).generate(
        jax.tree.map(jnp.asarray, batch), 7)
    got = Engine(tm, max_len=24).generate(batch, 7)
    assert got.n_prompt == want.n_prompt == tm.cfg.n_frontend_tokens + 6
    assert got.n_generated == want.n_generated == 7
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_audio_engine_refuses_as_the_reference_fails():
    jm, params, tm = _pair("musicgen-medium", seed=5)
    batch, _ = _batch(tm.cfg, 2, 6, seed=5)
    with pytest.raises(KeyError, match="tokens"):
        JEngine(jm, params, max_len=16, donate=False).generate(
            jax.tree.map(jnp.asarray, batch), 4)
    with pytest.raises(ValueError, match="token ids"):
        Engine(tm, max_len=16).generate(batch, 4)


def test_engine_refuses_a_prompt_longer_than_its_cache():
    _, _, tm = _pair("llava-v1.5-7b", seed=6)
    batch, _ = _batch(tm.cfg, 1, 6, seed=6)
    with pytest.raises(ValueError, match="does not fit"):
        Engine(tm, max_len=8).generate(batch, 2)


def test_serve_cli_vision_and_audio():
    """The serve CLI makes the reference's inputs: a vision arch serves
    (prompt = image tokens + text); an audio arch is refused by the Engine."""
    argv = ["--reduced", "--batch", "2", "--prompt-len", "10", "--gen", "3",
            "--device", "cpu"]
    res = serve.main(["--arch", "llava-v1.5-7b"] + argv)
    assert res.n_prompt == 10 and res.tokens.shape == (2, 3)
    with pytest.raises(ValueError, match="token ids"):
        serve.main(["--arch", "musicgen-medium"] + argv)


@pytest.mark.parametrize("name,prompt", [("llava-v1.5-7b", 640), ("internvl2-2b", 640),
                                         ("musicgen-medium", 64)])
def test_frontend_build_on_meta_counts_the_projection(name, prompt):
    """Full width: FLOPs of the prefill equal the analytic count plus the
    frontend's (F, d) x (d, d) product, 2·F·d²; decode is unchanged."""
    cfg = get_arch(name)
    pre, dec = build.build_generation(cfg, 1, 1, BuildFlags(), prompt_len=prompt,
                                      max_len=prompt + 65)
    f = cfg.n_frontend_tokens if cfg.frontend == "vision" else prompt
    want = analytic_flops(cfg, "prefill", prompt, 1) + 2 * f * cfg.d_model ** 2
    assert pre.artifact.flops_per_device == pytest.approx(want, rel=1e-12, abs=0)
    assert dec.artifact.flops_per_device == pytest.approx(
        analytic_flops(cfg, "decode", prompt + 65, 1), rel=1e-12, abs=0)
    inputs = build.prefill_inputs(cfg, 1, prompt, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in inputs.items()} == (
        {"image_embeds": (1, 576, cfg.d_model), "tokens": (1, prompt - 576)}
        if cfg.frontend == "vision" else {"frame_embeds": (1, prompt, cfg.d_model)})


def test_prompt_shorter_than_the_image_fails_in_both():
    """At explore's default prompt of 64, LLaVA would need 64 - 576 text
    tokens: the reference fails lowering (shown at reduced size, 2 - 4), the
    port refuses before building."""
    jcfg = jreduced(jget_arch("llava-v1.5-7b"))
    assert JModel(jcfg, JFlags()).input_specs(
        JShapeConfig("p", "prefill", 2, 1))["tokens"].shape == (1, -2)
    with pytest.raises(TypeError, match="nonnegative"):
        jbuild_generation(jcfg, make_host_mesh(), JFlags(), batch=1, prompt_len=2, max_len=10)
    with pytest.raises(ValueError, match="576 image tokens"):
        build.build_generation(get_arch("llava-v1.5-7b"), 1, 1, BuildFlags(), prompt_len=64,
                               max_len=129)
