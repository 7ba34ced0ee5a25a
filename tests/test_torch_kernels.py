"""K1, K2, K3 and K4 on the card against their plain PyTorch versions.

These need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

bf16 inputs; the kernel's bf16 output is held against the float32 plain
result from the same inputs at atol 2e-2 / rtol 2e-2 (the output rounding).
float32 inputs: 1e-5 (K1) and 1e-4 absolute (K2, sums of up to 128 products
in another order). K3 returns float32 and differs from its plain version
only in the order of the f32 sums: 1e-5 relative to the largest output.
Beyond agreement: K1 on every mask shape the engine builds and some it does
not (holes, one live slot at the end), and at B = 2, 4, 8 with a different
mask per lane (each lane bitwise equal to its own B=1 launch); K2 at every
main-path shape with 1, 2, 8, 9 and 16 rows; bitwise-equal repeated calls;
and both kernels captured in one CUDA graph and replayed on new inputs, at
B = 1 and at the shapes of an 8-lane pool. K2's tensor-map cache: views of
one buffer with other shapes, reallocated addresses, two launching threads.
K4 (int4 GEMV) at every main-path shape with 1, 2, 3, 4, 5, 8, 9 and 16
rows (1 and 2: either side of the switch to the tensor cores), other group
sizes and a very long reduction, bf16 (2e-2) and float32 (1e-4)
activations, its refusals, and a graph replay.
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


# one mask per lane of a batch (continuous batching): a fresh lane's prefix, a
# left-padded prompt, a full cache, one live slot at the end, a released
# lane's frozen range, a lane just inserted at slot 0, holes, a mature lane
LANE_KINDS = [(0, 40), (56, 300), (0, 2048), "last", (5, 133), (0, 1), "holes", (200, 460)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 4, 8])
@pytest.mark.parametrize("S", [2048, 17])
def test_decode_attention_kernel_batch(cuda_device, B, S):
    """Lanes of different ages in one launch (grid (cluster, Hkv, B)): each
    lane against the plain version, and against its own B=1 launch."""
    g = torch.Generator().manual_seed(B)
    q = torch.randn(B, 1, 16, 128, generator=g).to(cuda_device, torch.bfloat16)
    k, v = (torch.randn(B, S, 8, 128, generator=g).to(cuda_device, torch.bfloat16) for _ in range(2))
    kinds = LANE_KINDS if S == 2048 else [(0, 3), (0, 17), "last", (0, 9), (2, 17), (0, 1), (0, 5), (0, 16)]
    mask = torch.cat([_mask(S, kind) for kind in kinds[:B]]).to(cuda_device)
    before = attention.decode_attention.launches
    out = attention.decode_attention(q, k, v, mask)
    assert attention.decode_attention.launches == before + 1
    ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    for b in range(B):
        solo = attention.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], mask[b:b + 1])
        assert torch.equal(out[b:b + 1], solo), b


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
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16])
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
def test_int8_gemv_tensor_maps_follow_pointer_and_shape(cuda_device):
    """K2 caches one tensor map per weight: two views of one int8 buffer
    (same pointer, other I and O) and two weights freed and reallocated in
    turn (the allocator hands the address back) each stream their own
    matrix."""
    rng = np.random.default_rng(3)
    buf = torch.tensor(rng.integers(-127, 128, size=2048 * 3072, dtype=np.int8)).to(cuda_device)
    for I, O in ((1024, 3072), (2048, 1024), (3072, 2048), (1024, 2048)):
        q = buf[:I * O].view(I, O)
        assert q.data_ptr() == buf.data_ptr()
        scale = torch.rand(1, O, device=cuda_device) * 0.01
        x = torch.randn(1, I, device=cuda_device).to(torch.bfloat16)
        torch.testing.assert_close(quant.int8_gemv(x, q, scale).float(), quant.int8_gemv_plain(x.float(), q, scale),
                                   atol=2e-2, rtol=2e-2)
    del buf
    ptrs = []
    for seed, (I, O) in enumerate(((2048, 1024), (1024, 2048), (2048, 1024), (1024, 3072))):
        x, q, scale = _gemv_inputs(cuda_device, 2, I, O, seed=seed)
        ptrs.append(q.data_ptr())
        torch.testing.assert_close(quant.int8_gemv(x, q, scale).float(), quant.int8_gemv_plain(x.float(), q, scale),
                                   atol=2e-2, rtol=2e-2)
        del x, q, scale
    assert len(set(ptrs)) < len(ptrs)  # the caching allocator handed an address back


@pytest.mark.cuda
def test_int8_gemv_from_two_threads(cuda_device):
    """Two threads launching K2 at once, each on weights of its own shapes,
    each against its plain version (the server's threads share the
    library and its tensor-map cache)."""
    import threading

    cases = {t: [_gemv_inputs(cuda_device, 1 + t, I, O, seed=10 * t + i)
                 for i, (I, O) in enumerate(GEMV_SHAPES[:6])] for t in range(2)}
    refs = {t: [quant.int8_gemv_plain(x.float(), q, s) for x, q, s in cs] for t, cs in cases.items()}
    errors = []

    def work(t):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(20):
                    for (x, q, s), ref in zip(cases[t], refs[t]):
                        torch.testing.assert_close(quant.int8_gemv(x, q, s).float(), ref, atol=2e-2, rtol=2e-2)
        except Exception as e:  # noqa: BLE001 -- reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in cases]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors[0]


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    """Two calls on the same inputs give the same bits (sums in a fixed order)."""
    x, q, scale = _gemv_inputs(cuda_device, 2, 2048, 6144)
    assert torch.equal(quant.int8_gemv(x, q, scale), quant.int8_gemv(x, q, scale))
    qa, k, v = _attn_inputs(cuda_device, 2048)
    mask = _mask(2048, "holes").to(cuda_device)
    assert torch.equal(attention.decode_attention(qa, k, v, mask), attention.decode_attention(qa, k, v, mask))


def _batch_attn_inputs(device, B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g).to(device, torch.bfloat16)
            for shape in ((B, 1, 16, 128), (B, S, 8, 128), (B, S, 8, 128))]


def _batch_mask(B, S, shift):
    return torch.cat([_mask(S, LANE_KINDS[(b + shift) % len(LANE_KINDS)]) for b in range(B)])


@pytest.mark.cuda
@pytest.mark.parametrize("B, M", [(1, 1), (8, 8), (8, 16)], ids=["solo", "batch-M8", "batch-M16"])
def test_kernels_in_a_cuda_graph(cuda_device, B, M):
    """K1 and K2 captured in one CUDA graph and replayed on new inputs copied
    into the captured buffers give what eager calls give: they keep no state
    between launches. Also at the shapes of an 8-lane pool: K1 over 8 lanes
    with different masks, K2 at 8 and 16 rows."""
    x, q, scale = _gemv_inputs(cuda_device, M, 1024, 3072)
    qa, k, v = _batch_attn_inputs(cuda_device, B, 2048)
    mask = _batch_mask(B, 2048, 0).to(cuda_device) if B > 1 else _mask(2048, (0, 40)).to(cuda_device)
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
        x2, _, _ = _gemv_inputs(cuda_device, M, 1024, 3072, seed=seed)
        q2, k2, v2 = _batch_attn_inputs(cuda_device, B, 2048, seed=seed)
        mask2 = _batch_mask(B, 2048, seed) if B > 1 else _mask(2048, kind)
        for dst, src in ((x, x2), (qa, q2), (k, k2), (v, v2), (mask, mask2.to(cuda_device))):
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


# K4: every int4 projection shape of the 0.6B and 1.7B models (GEMV_SHAPES),
# an input width that is one group (48: the tiny-layer fallback) and groups
# that do not fill a cluster evenly (160 rows: 5 groups)
GEMV4_SHAPES = GEMV_SHAPES + [(48, 32)]


def _gemv4_inputs(device, M, I, O, seed=0, dtype=torch.bfloat16, group=32):
    w = (np.random.default_rng(seed).standard_normal((I, O)) * 0.05).astype(np.float32)
    ql = quant.quantize_linear4(w, group)
    packed, scale, wmin = (torch.tensor(a).to(device) for a in ql)
    x = torch.randn(M, I, generator=torch.Generator().manual_seed(seed + 1)).to(device, dtype)
    return x, packed, scale, wmin


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16])  # 1 / 2: the last CUDA-core and first mma row counts
@pytest.mark.parametrize("I, O", GEMV4_SHAPES)
def test_int4_gemv_kernel(cuda_device, M, I, O):
    x, packed, scale, wmin = _gemv4_inputs(cuda_device, M, I, O)
    before = quant.int4_gemv.launches
    out = quant.int4_gemv(x, packed, scale, wmin)
    assert quant.int4_gemv.launches == before + 1
    ref = quant.int4_gemv_plain(x.float(), packed, scale, wmin)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    assert torch.equal(out, quant.int4_gemv(x, packed, scale, wmin))  # sums in a fixed order


# (M, I, O, group): ten groups of 48 on the tensor cores (16 and 4 rows) and
# on the CUDA cores (1 row); groups of 2 and of 6 (not a multiple of 16: CUDA
# cores at every row count); a very long reduction on both paths (16 rows of
# x do not fit beside it: two CTAs of 8 rows)
K4_GROUP_CASES = [(16, 480, 64, 48), (4, 480, 64, 48), (1, 480, 64, 48), (16, 64, 32, 2), (7, 96, 48, 6),
                  (1, 32768, 128, 32), (16, 32768, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("M, I, O, group", K4_GROUP_CASES)
def test_int4_gemv_kernel_other_groups(cuda_device, M, I, O, group):
    x, packed, scale, wmin = _gemv4_inputs(cuda_device, M, I, O, group=group)
    assert I // scale.shape[0] == group
    out = quant.int4_gemv(x, packed, scale, wmin)
    ref = quant.int4_gemv_plain(x.float(), packed, scale, wmin)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    assert torch.equal(out, quant.int4_gemv(x, packed, scale, wmin))


@pytest.mark.cuda
@pytest.mark.parametrize("M, I, O", [(3, 128, 64), (1, 1024, 3072), (16, 2048, 1024), (16, 6144, 2048)])
def test_int4_gemv_kernel_float32(cuda_device, M, I, O):
    """float32 activations, as in the card-vs-CPU reference run: f32 sums of
    up to 6144 products in another order."""
    x, packed, scale, wmin = _gemv4_inputs(cuda_device, M, I, O, dtype=torch.float32)
    torch.testing.assert_close(quant.int4_gemv(x, packed, scale, wmin),
                               quant.int4_gemv_plain(x, packed, scale, wmin), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_int4_gemv_refuses_what_k4_does_not_take(cuda_device):
    x, packed, scale, wmin = _gemv4_inputs(cuda_device, 2, 128, 64)
    before = quant.int4_gemv.launches
    with pytest.raises(ValueError):  # O % 16 != 0
        quant.int4_gemv(x, packed[:, :40].contiguous(), scale[:, :40].contiguous(), wmin[:, :40].contiguous())
    with pytest.raises(ValueError):  # more than 16 rows
        quant.int4_gemv(torch.randn(17, 128, device=cuda_device).to(torch.bfloat16), packed, scale, wmin)
    with pytest.raises(ValueError, match="CUDA"):  # a CPU weight with a CUDA activation
        quant.int4_gemv(x, packed.cpu(), scale, wmin)
    with pytest.raises(TypeError):
        quant.int4_gemv(x, packed.to(torch.int8), scale, wmin)
    assert quant.int4_gemv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16])
def test_int4_gemv_in_a_cuda_graph(cuda_device, M):
    """K4 captured in a CUDA graph and replayed on new inputs copied into the
    captured buffers gives what an eager call gives."""
    x, packed, scale, wmin = _gemv4_inputs(cuda_device, M, 1024, 3072)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.int4_gemv(x, packed, scale, wmin)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = quant.int4_gemv(x, packed, scale, wmin)
    for seed in (5, 6):
        for dst, src in zip((x, packed, scale, wmin), _gemv4_inputs(cuda_device, M, 1024, 3072, seed=seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, quant.int4_gemv(x, packed, scale, wmin))


def test_int4_gemv_refuses_tensors_that_are_neither_cpu_nor_cuda():
    before = quant.int4_gemv.launches
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        quant.int4_gemv(torch.empty(1, 64, device=meta), torch.empty(32, 64, dtype=torch.uint8, device=meta),
                        torch.empty(2, 64, device=meta), torch.empty(2, 64, device=meta))
    assert quant.int4_gemv.launches == before


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
