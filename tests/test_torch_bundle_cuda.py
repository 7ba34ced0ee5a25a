"""The serving restart on the card: the torch quantizers on CUDA tensors
against the numpy ones, K2 and K4 on leaves unpacked from a deploy bundle,
and the memory a quantization on the card leaves behind.

These need an NVIDIA GPU and skip without one. The file imports no jax:

    python -m pytest tests/test_torch_bundle_cuda.py --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.ops import quant


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bundle's device half and the kernels run on the card)")
    return torch.device("cuda")


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return t.numpy().reshape(-1).view(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 3072), (28, 1024, 1024), (2, 72, 48)])
def test_torch_quantizers_on_the_card_equal_numpy(cuda_device, shape):
    """q and packed exact, scale and wmin bit for bit (the divisors are
    device tensors: CUDA would multiply by a scalar's reciprocal)."""
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    host_w = w.float().numpy()
    for np_fn, torch_fn in ((quant.quantize_linear, quant.quantize_linear_torch),
                            (quant.quantize_linear4, quant.quantize_linear4_torch)):
        want, got = np_fn(host_w), torch_fn(w.to(cuda_device))
        for a, b in zip(want, got):
            assert b.device.type == "cuda" and a.dtype == b.cpu().numpy().dtype and a.shape == tuple(b.shape)
            assert np.array_equal(a.reshape(-1).view(np.uint8), _bits(b))


def _tiny_config():
    return dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                               tts_pad_token_id=302)


def _bundle_tree():
    """The tiny tree in Q8_4 (talker int8, predictor int4) with an odd-sized
    leaf at the head of every section, so that back-to-back leaves lose
    their 16-byte alignment inside the sections."""
    cfg = _tiny_config()
    host = weights.host_tree(weights.init_all(cfg, device="cpu", quant="mixed"))
    host["aaa"] = {name: torch.ones(3, dtype=dt) for name, dt in (
        ("bf16", torch.bfloat16), ("f32", torch.float32), ("i8", torch.int8), ("u8", torch.uint8))}
    return cfg, host


@pytest.mark.cuda
def test_k2_and_k4_run_on_leaves_unpacked_from_a_bundle(cuda_device, tmp_path):
    cfg, host = _bundle_tree()
    weights.save_deploy_bundle(tmp_path, host, cfg, quant_mode="mixed")
    params, _, mode = weights.load_deploy_bundle(tmp_path, device="cuda")
    assert mode == "mixed"
    leaves = weights._leaves(params)
    assert all(t.is_cuda and t.data_ptr() % 16 == 0 for t in leaves)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == len(leaves)  # no section kept alive
    g = torch.Generator().manual_seed(0)
    w8 = params["talker"]["layers"]["w_up"]
    w4 = params["predictor"]["layers"]["w_up"]
    for w, kernel, plain in ((w8, quant.int8_gemv, quant.int8_gemv_plain),
                             (w4, quant.int4_gemv, quant.int4_gemv_plain)):
        layer = type(w)(*(x[1] for x in w))  # layer 1: a slice of the stacked leaf, still aligned
        I = layer[0].shape[0] * (2 if w is w4 else 1)
        x = torch.randn(2, I, generator=g).to(cuda_device, torch.bfloat16)
        before = kernel.launches
        got, want = kernel(x, *layer), plain(x, *layer)
        assert kernel.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_quantization_on_the_card_frees_the_float_leaves(cuda_device, tmp_path):
    """An unquantized bundle quantized on the card: once the float tree is
    dropped, the card holds the quantized tree's bytes (within 1 %) and no
    section."""
    cfg = _tiny_config()
    weights.save_deploy_bundle(tmp_path, weights.host_tree(weights.init_all(cfg, device="cpu")), cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, _, _ = weights.load_deploy_bundle(tmp_path, device="cuda")
    params = quant.quantize_model_params(params, "int8")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    nbytes = sum(t.numel() * t.element_size() for t in weights._leaves(params))
    assert abs(held - nbytes) <= 0.01 * nbytes + 512 * len(weights._leaves(params)), (held, nbytes)
