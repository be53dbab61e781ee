"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card.  This file imports torch
and the port only (no JAX), so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from handyrl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(rows, T, H, D, dtype, observed=0.7, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(rows, T, H, D, generator=g).to(dtype).cuda() for _ in range(3))
    key_mask = (torch.rand(rows, T, generator=g) < observed).float().cuda()
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)]).cuda()
    return q, k, v, key_mask, slopes


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,window", [(100, 16), (256, 1 << 30)])
def test_kernel_matches_plain_version(dtype, tol, T, window):
    """fp32: another summation order (1e-4); bf16: bf16 inputs and output
    against the fp32 plain version of the same inputs (2e-2)."""
    _need_card()
    q, k, v, km, sl = _inputs(3, T, 2, 96, dtype)
    launches = fa.MASKED_FLASH.launches
    out = fa.masked_flash_attention(q, k, v, km, sl, window=window)
    torch.cuda.synchronize()
    assert fa.MASKED_FLASH.launches == launches + 1
    ref = fa.masked_attention_reference(q.float(), k.float(), v.float(), km, sl, window)
    assert (out.float() - ref).abs().max().item() <= tol


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q, k, v, km, sl = _inputs(2, 64, 2, 24, torch.float32)
    with pytest.raises(ValueError):
        fa.masked_flash_kernel(q, k, v, km, sl)          # head dim 24
    q, k, v, km, sl = _inputs(2, 64, 2, 16, torch.float16)
    with pytest.raises(TypeError):
        fa.masked_flash_kernel(q, k, v, km, sl)          # fp16
