"""K1, K2 and K3 on the card against their plain PyTorch versions.

These need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

bf16 inputs; the kernel's bf16 output is held against the float32 plain
result from the same inputs at atol 2e-2 / rtol 2e-2 (the output rounding).
float32 inputs: 1e-5 (K1) and 1e-4 absolute (K2, sums of up to 128 products
in another order). K3 returns float32 and differs from its plain version
only in the order of the f32 sums: 1e-5 relative to the largest output.
Beyond agreement: K1 on every mask shape the engine builds and some it does
not (holes, one live slot at the end), K2 at every main-path shape with 1,
2, 9 and 16 rows, bitwise-equal repeated calls, and both kernels captured in
one CUDA graph and replayed on new inputs.
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


def _mask(S, kind):
    """int32 [1, S] masks of the shapes the engine builds, and harder ones."""
    s = np.arange(S)
    if kind == "holes":  # live runs with dead tiles and dead slots between them
        live = ((s % 97) < 40) | (s == S - 1)
    elif kind == "last":  # a single live slot, at the end
        live = s == S - 1
    else:  # a live range [lo, hi): a prefix, a left-padded range, every slot
        lo, hi = kind
        live = (s >= lo) & (s < hi)
    return torch.tensor(live.astype(np.int32))[None]


def _attn_inputs(device, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g).to(device, torch.bfloat16)
            for shape in ((1, 1, 16, 128), (1, S, 8, 128), (1, S, 8, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("S, kind", [(2048, (0, 40)), (2048, (56, 300)), (2048, "holes"), (2048, "last"),
                                     (2048, (0, 2048)), (2048, (30, 2048)), (17, (0, 5)), (17, (0, 17)),
                                     (17, "last"), (300, "holes")])
def test_decode_attention_kernel(cuda_device, S, kind):
    q, k, v = _attn_inputs(cuda_device, S)
    mask = _mask(S, kind).to(cuda_device)
    before = attention.decode_attention.launches
    out = attention.decode_attention(q, k, v, mask)
    assert attention.decode_attention.launches == before + 1
    ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_decode_attention_kernel_float32_tiny_heads(cuda_device):
    """The tiny geometry of the card-vs-CPU reference run: float32, D = 32."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 1, 4, 32, generator=g).to(cuda_device)
    k, v = (torch.randn(1, 64, 2, 32, generator=g).to(cuda_device) for _ in range(2))
    mask = _mask(64, (3, 50)).to(cuda_device)
    out = attention.decode_attention(q, k, v, mask)
    torch.testing.assert_close(out, attention.decode_attention_plain(q, k, v, mask), atol=1e-5, rtol=1e-5)


# every Q8_0 projection shape of the 0.6B and 1.7B talkers and their predictor,
# and edge shapes: I not a multiple of the 64-row stage, O of the 128-column tile
GEMV_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024), (2048, 2048),
               (2048, 6144), (6144, 2048), (2048, 3072), (96, 128), (160, 48)]


def _gemv_inputs(device, M, I, O, seed=0):
    w = np.random.default_rng(seed).standard_normal((I, O)).astype(np.float32)
    ql = quant.quantize_linear(w)
    q, scale = torch.tensor(ql.q).to(device), torch.tensor(ql.scale).to(device)
    x = torch.randn(M, I, generator=torch.Generator().manual_seed(seed + 1)).to(device, torch.bfloat16)
    return x, q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 9, 16])
@pytest.mark.parametrize("I, O", GEMV_SHAPES)
def test_int8_gemv_kernel(cuda_device, M, I, O):
    x, q, scale = _gemv_inputs(cuda_device, M, I, O)
    before = quant.int8_gemv.launches
    out = quant.int8_gemv(x, q, scale)
    assert quant.int8_gemv.launches == before + 1
    ref = quant.int8_gemv_plain(x.float(), q, scale)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_int8_gemv_kernel_float32(cuda_device):
    """float32 activations, as in the card-vs-CPU reference run."""
    x, q, scale = _gemv_inputs(cuda_device, 3, 128, 64)
    x = x.float()
    torch.testing.assert_close(quant.int8_gemv(x, q, scale), quant.int8_gemv_plain(x, q, scale),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    """Two calls on the same inputs give the same bits (sums in a fixed order)."""
    x, q, scale = _gemv_inputs(cuda_device, 2, 2048, 6144)
    assert torch.equal(quant.int8_gemv(x, q, scale), quant.int8_gemv(x, q, scale))
    qa, k, v = _attn_inputs(cuda_device, 2048)
    mask = _mask(2048, "holes").to(cuda_device)
    assert torch.equal(attention.decode_attention(qa, k, v, mask), attention.decode_attention(qa, k, v, mask))


@pytest.mark.cuda
def test_kernels_in_a_cuda_graph(cuda_device):
    """K1 and K2 captured in one CUDA graph and replayed on new inputs copied
    into the captured buffers give what eager calls give: they keep no state
    between launches."""
    x, q, scale = _gemv_inputs(cuda_device, 1, 1024, 3072)
    qa, k, v = _attn_inputs(cuda_device, 2048)
    mask = _mask(2048, (0, 40)).to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (builds, attributes, tensor maps) off the capture
        quant.int8_gemv(x, q, scale)
        attention.decode_attention(qa, k, v, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = quant.int8_gemv(x, q, scale)
        o = attention.decode_attention(qa, k, v, mask)
    for seed, kind in ((5, (56, 300)), (6, "holes")):
        x2, _, _ = _gemv_inputs(cuda_device, 1, 1024, 3072, seed=seed)
        q2, k2, v2 = _attn_inputs(cuda_device, 2048, seed=seed)
        for dst, src in ((x, x2), (qa, q2), (k, k2), (v, v2), (mask, _mask(2048, kind).to(cuda_device))):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, quant.int8_gemv(x, q, scale))
        assert torch.equal(o, attention.decode_attention(qa, k, v, mask))


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
