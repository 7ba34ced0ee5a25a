"""The port's parameter trees against the JAX package's, bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.config import get_config
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.ops import quant

torch.set_num_threads(1)


def _leaves(node, path=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}/{i}")
    elif getattr(node, "_fields", None):
        for name, v in zip(node._fields, node):
            yield f"{path}.{name}", v
    else:
        yield path, node


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_all_matches_jax_bit_for_bit(tiny_config, dtype):
    jax_tree = jax_weights.init_all(tiny_config, seed=3, dtype=getattr(jnp, dtype), device_put=False)
    port = weights.init_all(tiny_config, seed=3, dtype=getattr(torch, dtype))
    _assert_trees_equal(port, weights.params_from_numpy(jax_tree))


def test_init_numpy_draws_the_jax_streams(tiny_config):
    jax_tree = jax_weights.init_all(tiny_config, seed=5, dtype=jnp.float32, device_put=False)
    la = list(_leaves(weights.init_numpy(tiny_config, seed=5)))
    lb = list(_leaves(jax_tree))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=path)


def test_init_numpy_at_the_1_7b_widths(tiny_config):
    """The 1.7B geometry (talker 2048 wide with a 6144 FFN, a 2048 -> 1024
    mtp_proj into the predictor) draws the JAX package's tree; cut to one
    layer per stack, a 512-token text vocabulary, 64 predictor codes and the
    tiny codec, so that it stays small on the CPU."""
    full = get_config("1.7b")
    cfg = dataclasses.replace(
        full, talker=dataclasses.replace(full.talker, num_hidden_layers=1, text_vocab_size=512),
        predictor=dataclasses.replace(full.predictor, num_hidden_layers=1, vocab_size=64),
        codec=tiny_config.codec)
    port = weights.init_numpy(cfg, seed=0)
    assert port["talker"]["layers"]["w_gate"].shape == (1, 2048, 6144)
    assert port["talker"]["layers"]["w_down"].shape == (1, 6144, 2048)
    assert port["predictor"]["mtp_proj"]["w"].shape == (2048, 1024)
    jax_tree = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    la, lb = list(_leaves(port)), list(_leaves(jax_tree))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=path)


def test_quantized_init_matches_jax(tiny_config):
    jax_tree = jax_quant.quantize_model_params(
        jax_weights.init_all(tiny_config, seed=1, dtype=jnp.bfloat16, device_put=False), "int8"
    )
    port = weights.init_all(tiny_config, seed=1, dtype=torch.bfloat16, quant="int8")
    _assert_trees_equal(port, weights.params_from_numpy(jax_tree))
    assert isinstance(port["talker"]["layers"]["wq"], quant.QuantizedLinear)
    assert port["talker"]["layers"]["wq"].q.dtype == torch.int8


def _to_jax_layout(path, t):
    """Undo the port's codec conv layouts (weights._codec_layout)."""
    name = path.rsplit("/", 1)[-1]
    if "/codec/" in path + "/" and name == "up_w":
        return t.permute(2, 0, 1).flip(0)
    if "/codec/" in path + "/" and name in ("dw_w", "c1_w", "c2_w", "dec_in_w", "dec_out_w"):
        return t.permute(2, 1, 0)
    return t


def test_params_from_numpy_round_trips_every_leaf(tiny_config):
    host = jax_quant.quantize_model_params(
        jax_weights.init_all(tiny_config, seed=2, dtype=jnp.bfloat16, device_put=False), "int8"
    )
    port = weights.params_from_numpy(host)
    la, lb = list(_leaves(host)), list(_leaves(port))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x = np.asarray(x)
        y = _to_jax_layout(path, y)
        if x.dtype.name == "bfloat16":
            assert y.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(x.view(np.int16), y.view(torch.int16).numpy(), err_msg=path)
        else:
            np.testing.assert_array_equal(x, y.numpy(), err_msg=path)
