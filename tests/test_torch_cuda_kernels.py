"""K3's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and nvcc; where PyTorch sees no device
they skip (decided inside the fixture, so every worker collects the same
tests).  This file imports no JAX: the machine with the card has none.
Run it there with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2;
a bf16 output is also held against the plain version in fp32 at one bf16
rounding (atol 1e-4, rtol 2**-8).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import BuildFlags, Model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; PyTorch sees none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, s, h, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("s,h,hkv,d", [
    (64, 4, 4, 32), (128, 8, 2, 64), (96, 6, 1, 32), (128, 4, 4, 128),
    (200, 4, 2, 16),          # ragged edge: 200 is not a tile multiple
    (1, 2, 1, 64),            # a single position
    (17, 32, 32, 128),        # llama2-7b heads, a partly filled q tile
])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_matches_plain(cuda, s, h, hkv, d, window, dtype):
    q, k, v = _qkv(cuda, 2, s, h, hkv, d, dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # The kernel computes in fp32: against the plain version in fp32 on
        # the same inputs it is off by one bf16 rounding of the output.
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=True, window=window)
        torch.testing.assert_close(got.float(), want32, atol=1e-4, rtol=2 ** -8)


def test_kernel_noncausal(cuda):
    q, k, v = _qkv(cuda, 1, 80, 4, 4, 64, torch.float32, seed=1)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 32, torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def test_flash_prefill_matches_xla_on_card(cuda):
    cfg = reduced(get_arch("tinyllama-1.1b"))
    flash = Model(cfg, BuildFlags(dtype="float32", attn_impl="flash"), device=cuda, seed=0)
    xla = Model(cfg, BuildFlags(dtype="float32", attn_impl="xla"), device=cuda, seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    before = fa.flash_attention.launches
    with torch.inference_mode():
        lf, _ = flash.prefill({"tokens": toks})
        lx, _ = xla.prefill({"tokens": toks})
    assert fa.flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(lf, lx, atol=5e-5, rtol=5e-5)
