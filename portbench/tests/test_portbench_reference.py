"""Each plain reference against the port's CPU path at a reduced size:
prefill, then greedy decode through the cache, in float32."""
import numpy as np
import pytest
import torch

from portbench import check, weights
from portbench.harness import port_arch
from portbench.reference.common import Precision, fp8
from portbench.tests._tiny import config


def _port_logits(cfg, prompt, n_new, seed):
    """The port's logits for a prompt and its n_new greedy tokens."""
    from repro_torch.models.model import BuildFlags, Model
    from repro_torch.serve.engine import pad_caches

    model = Model(port_arch(cfg), BuildFlags(dtype="float32", attn_impl=cfg["attn_impl"],
                                             ssd_impl=cfg["ssd_impl"]),
                  device="cpu", seed=None)
    params = weights.fill(model, seed)
    with torch.inference_mode():
        logits, caches = model.prefill({"tokens": prompt[None]})
        caches = pad_caches(caches, prompt.numel(), prompt.numel() + n_new)
        out, toks = [logits[0]], [int(logits[0].argmax())]
        for pos in range(prompt.numel(), prompt.numel() + n_new - 1):
            logits, caches = model.decode_step(torch.tensor([[toks[-1]]]), caches, pos)
            out.append(logits[0])
            toks.append(int(logits[0].argmax()))
    return params, torch.stack(out), torch.tensor(toks)


@pytest.mark.parametrize("name", ["dsmoe16b", "mamba2"])
@pytest.mark.parametrize("plen", [5, 37])
def test_reference_matches_the_port(name, plen):
    cfg = config(name)
    prompt = torch.randint(0, cfg["vocab_size"], (plen,), generator=torch.Generator().manual_seed(plen))
    params, port, served = _port_logits(cfg, prompt, 9, seed=2**33 + plen)
    ref = check.reference(cfg).served_logits(params, cfg, prompt, served)
    scale = port.abs().max()
    assert torch.allclose(ref, port, atol=1e-5 * scale, rtol=0), float((ref - port).abs().max())
    low = check.reference(cfg).served_logits(params, cfg, prompt, served, Precision(control=True))
    assert (low - ref).abs().max() > 100 * (port - ref).abs().max()


def test_moe_capacity_drops_follow_the_prompt_group():
    """A prompt long enough that the tiny MoE drops assignments: the
    reference agrees only because it drops the same ones."""
    from portbench.reference import decoder

    cfg = config("dsmoe16b")
    assert decoder.capacity(40, cfg) == 16 and decoder.capacity(1, cfg) == 8
    prompt = torch.full((120,), 3)                     # every token routes alike: drops
    params, port, served = _port_logits(cfg, prompt, 4, seed=5)
    ref = decoder.served_logits(params, cfg, prompt, served)
    assert torch.allclose(ref, port, atol=1e-5 * port.abs().max(), rtol=0)
    undropped = dict(cfg, capacity_factor=100.0)
    assert not torch.allclose(decoder.served_logits(params, undropped, prompt, served), port,
                              atol=1e-3 * port.abs().max(), rtol=0)


def test_fp8_rounding():
    t = torch.tensor([[1.0, 0.3, -448.0], [2.0, 0.0, 1e-3]])
    r = fp8(t, -1)
    assert r[0, 2] == -448.0 and r[1, 0] == 2.0 and r[1, 1] == 0.0
    assert 0 < (r - t).abs().max() <= 0.07 * t.abs().max()


def test_weights_from_the_seed():
    from repro_torch.models.model import BuildFlags, Model

    cfg = config("mamba2")
    arch = port_arch(cfg)
    a = weights.fill(Model(arch, BuildFlags(dtype="float32"), device="cpu", seed=None), 2**40)
    b = weights.fill(Model(arch, BuildFlags(dtype="float32"), device="cpu", seed=None), 2**40)
    c = weights.fill(Model(arch, BuildFlags(dtype="float32"), device="cpu", seed=None), 7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])
    assert torch.equal(a["stack.layers.0.mixer.D"], torch.ones(arch.n_ssm_heads))
    assert a["stack.layers.0.mixer.conv_x"].std() == pytest.approx(0.1, rel=0.2)
    assert "head.w" not in a                           # tied to the embedding, as published
    assert a["embed.table"].std() == pytest.approx(0.02, rel=0.1)
