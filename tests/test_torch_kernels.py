"""K1, K2 and K3 on the card against their plain PyTorch versions.

These need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

bf16 inputs; the kernel's bf16 output is held against the float32 plain
result from the same inputs at atol 2e-2 / rtol 2e-2 (the output rounding).
K3 returns float32 and differs from its plain version only in the order of
the f32 sums: 1e-5 relative to the largest output.
"""
import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch.ops import attention, quant
from faster_qwen3_tts_tpu_torch.ops import weight_stream as ws


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S, lo, hi", [(2048, 0, 40), (2048, 30, 2048), (17, 0, 5)])
def test_decode_attention_kernel(cuda_device, S, lo, hi):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1, 16, 128, generator=g).to(cuda_device, torch.bfloat16)
    k = torch.randn(1, S, 8, 128, generator=g).to(cuda_device, torch.bfloat16)
    v = torch.randn(1, S, 8, 128, generator=g).to(cuda_device, torch.bfloat16)
    s = torch.arange(S)
    mask = ((s >= lo) & (s < hi)).to(torch.int32)[None].to(cuda_device)
    out = attention.decode_attention(q, k, v, mask)
    ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M, I, O", [(1, 1024, 3072), (2, 1024, 1024), (1, 3072, 1024), (9, 1024, 2048),
                                     (1, 2048, 6144), (2, 6144, 2048), (2, 2048, 3072)])
def test_int8_gemv_kernel(cuda_device, M, I, O):
    w = np.random.default_rng(0).standard_normal((I, O)).astype(np.float32)
    ql = quant.quantize_linear(w)
    q, scale = torch.tensor(ql.q).to(cuda_device), torch.tensor(ql.scale).to(cuda_device)
    x = torch.randn(M, I, generator=torch.Generator().manual_seed(1)).to(cuda_device, torch.bfloat16)
    out = quant.int8_gemv(x, q, scale)
    ref = quant.int8_gemv_plain(x.float(), q, scale)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("L, I, O", [(28, 1024, 6144), (3, 2048, 12288), (2, 96, 128)])
def test_weight_stream_kernel(cuda_device, L, I, O):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randint(-127, 127, (L, I, O), dtype=torch.int8, device=cuda_device, generator=g)
    x = (torch.randn(1, I, device=cuda_device, generator=g) * 0.1).to(torch.bfloat16)
    before = ws.weight_stream.launches
    out = ws.weight_stream(x, w)
    ref = ws.weight_stream_plain(x, w)
    assert ws.weight_stream.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def test_wrappers_refuse_tensors_that_are_neither_cpu_nor_cuda():
    before = (attention.decode_attention.launches, quant.int8_gemv.launches, ws.weight_stream.launches)
    meta = torch.device("meta")
    q = torch.empty(1, 1, 4, 16, device=meta)
    cache = torch.empty(1, 8, 2, 16, device=meta)
    mask = torch.empty(1, 8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        attention.decode_attention(q, cache, cache, mask)
    with pytest.raises(ValueError, match="CUDA"):
        quant.int8_gemv(torch.empty(1, 32, device=meta), torch.empty(32, 64, dtype=torch.int8, device=meta),
                        torch.empty(1, 64, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        ws.weight_stream(torch.empty(1, 32, dtype=torch.bfloat16, device=meta),
                         torch.empty(2, 32, 64, dtype=torch.int8, device=meta))
    assert (attention.decode_attention.launches, quant.int8_gemv.launches,
            ws.weight_stream.launches) == before
