"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card.  This file imports torch
and the port only (no JAX), so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import importlib

import pytest
import torch

# the module: the ops package exports the function under the same name
fa = importlib.import_module("handyrl_tpu_torch.ops.flash_attention")

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


HEAD_DIMS = (16, 32, 64, 96, 128)   # the kernels' instantiated head dims
TOLERANCES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-3)]


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("T,window", [(100, 16), (256, 1 << 30), (1024, 32), (1024, 1 << 30)])
def test_kernel_matches_plain_version(dtype, tol, D, T, window):
    """fp32 (FMA): another summation order (1e-4); bf16 and fp16 (wgmma):
    inputs, probabilities and output rounded to the type, against the fp32
    plain version of the same inputs (2e-2, 2e-3).  Every head dim is its
    own shared-memory layout, at a ragged T and at T1024."""
    _need_card()
    q, k, v, km, sl = _inputs(2, T, 2, D, dtype)
    launches = fa.MASKED_FLASH.launches
    out = fa.masked_flash_attention(q, k, v, km, sl, window=window)
    torch.cuda.synchronize()
    assert fa.MASKED_FLASH.launches == launches + 1
    ref = fa.masked_attention_reference(q.float(), k.float(), v.float(), km, sl, window)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("D,dtype,tol", [(24, torch.float32, 1e-4), (96, torch.float16, 2e-3),
                                         (24, torch.float16, 2e-3)])
def test_kernel_takes_any_head_dim_and_fp16(D, dtype, tol):
    """Head dim 24 runs zero-padded to 32; fp16 (10 bits of mantissa on O(1)
    outputs: 2e-3) against the fp32 plain version of the same inputs."""
    _need_card()
    q, k, v, km, sl = _inputs(3, 100, 2, D, dtype)
    launches = fa.MASKED_FLASH.launches
    out = fa.masked_flash_attention(q, k, v, km, sl, window=16)
    torch.cuda.synchronize()
    assert fa.MASKED_FLASH.launches == launches + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    ref = fa.masked_attention_reference(q.float(), k.float(), v.float(), km, sl, 16)
    assert (out.float() - ref).abs().max().item() <= tol


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q, k, v, km, sl = _inputs(2, 64, 2, 16, torch.float64)
    with pytest.raises(TypeError):
        fa.masked_flash_kernel(q, k, v, km, sl)          # fp64
    with pytest.raises(TypeError):
        fa.flash_kernel(q, k, v)


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(3, 100, 2, 24), (2, 256, 2, 64)]
                         + [(2, T, 2, D) for D in HEAD_DIMS for T in (100, 1024)])
def test_flash_kernel_matches_plain_version(dtype, tol, causal, shape):
    """The plain flash kernel through ``flash_attention`` against
    ``full_attention_reference`` on the same inputs widened to fp32."""
    _need_card()
    q, k, v, _, _ = _inputs(*shape, dtype, seed=1)
    launches = fa.FLASH.launches
    out = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.FLASH.launches == launches + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = fa.full_attention_reference(q.float(), k.float(), v.float(), causal)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("layout", ["unbound_qkv", "transposed"])
@pytest.mark.parametrize("op", ["flash_attention", "masked_flash_attention"])
def test_public_wrappers_take_strided_views(op, layout):
    """q, k, v unbound from a fused qkv projection, or transposed views,
    launch the kernel and match the plain version."""
    _need_card()
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(2, 128, 3, 2, 64, generator=g).cuda()
    q, k, v = x.unbind(2)
    if layout == "transposed":
        q, k, v = (y.transpose(1, 2).contiguous().transpose(1, 2) for y in (q, k, v))
    assert not q.is_contiguous()
    counter = fa.MASKED_FLASH if op == "masked_flash_attention" else fa.FLASH
    launches = counter.launches
    if op == "masked_flash_attention":
        km = (torch.rand(2, 128, generator=g) < 0.7).float().cuda()
        sl = torch.tensor([0.5, 0.25]).cuda()
        out = fa.masked_flash_attention(q, k, v, km, sl, window=16)
        ref = fa.masked_attention_reference(q, k, v, km, sl, 16)
    else:
        out = fa.flash_attention(q, k, v, True)
        ref = fa.full_attention_reference(q, k, v, True)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("op", ["flash_kernel", "masked_flash_kernel"])
def test_raw_launches_take_a_misaligned_view(op, dtype, tol):
    """Contiguous views that start one element past an aligned allocation
    (TMA needs 16-byte aligned bases) reach the kernel as aligned copies."""
    _need_card()
    g = torch.Generator(device="cpu").manual_seed(3)
    flat = torch.randn(3 * 2 * 100 * 2 * 96 + 1, generator=g).to(dtype).cuda()
    q, k, v = (x.view(2, 100, 2, 96) for x in flat[1:].view(3, 2, 100, 2, 96).unbind(0))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    km = (torch.rand(2, 100, generator=g) < 0.7).float().cuda()
    sl = torch.tensor([0.5, 0.25]).cuda()
    counter = fa.MASKED_FLASH if op == "masked_flash_kernel" else fa.FLASH
    launches = counter.launches
    if op == "masked_flash_kernel":
        out = fa.masked_flash_kernel(q, k, v, km, sl, 16)
        ref = fa.masked_attention_reference(q.float(), k.float(), v.float(), km, sl, 16)
    else:
        out = fa.flash_kernel(q, k, v, True)
        ref = fa.full_attention_reference(q.float(), k.float(), v.float(), True)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert (out.float() - ref).abs().max().item() <= tol
