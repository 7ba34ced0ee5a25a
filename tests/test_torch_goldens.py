"""The JAX package's golden regression artifacts (samples/goldens/, pinned by
tests/test_goldens.py) over the port, on the CPU, with the JAX package's host
init and the seeds of tests/test_goldens.py:

- the greedy token stream of the port's `fast_generate` against
  `tiny_greedy_tokens.npz`, exactly;
- the port's `codec.decode_frames` on a fixed code sequence against
  `tiny_codec_wav.npz`, at atol 2e-5.

This test never writes a golden: a missing file fails. The sampled golden
(`tiny_sampled_tokens.npz`) is left out: it pins the JAX package's PRNG key
splits, which the port's torch generators do not reproduce."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.models import codec as jax_codec
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
from faster_qwen3_tts_tpu_torch.models import codec

torch.set_num_threads(1)
GOLDEN_DIR = Path(__file__).resolve().parent.parent / "samples" / "goldens"


def _golden(name):
    path = GOLDEN_DIR / name
    assert path.is_file(), f"golden {path} is missing (tests/test_goldens.py writes it)"
    return np.load(path)


def test_golden_greedy_tokens(tiny_config):
    host = jax_weights.init_all(tiny_config, seed=5, dtype=jnp.float32, device_put=False)
    params = weights.params_from_numpy(host, device="cpu")
    H = tiny_config.talker.hidden_size
    rng = np.random.default_rng(11)
    tie = (rng.standard_normal((1, 20, H)) * 0.05).astype(np.float32)
    mask = np.ones((1, 20), np.int32)
    tth = (rng.standard_normal((1, 6, H)) * 0.05).astype(np.float32)
    tpe = (rng.standard_normal((1, 1, H)) * 0.05).astype(np.float32)
    codes, _ = gen_lib.fast_generate(params, tiny_config, tie, mask, tth, tpe, max_seq_len=64, max_new_tokens=24,
                                     seed=3, device_chunk=8, do_sample=False, subtalker_dosample=False)
    want = _golden("tiny_greedy_tokens.npz")["codes"]
    assert codes.shape == want.shape == (24, 16)
    np.testing.assert_array_equal(codes.astype(np.int32), want)


def test_golden_codec_waveform(tiny_config):
    host = jax_codec.init_params(2000, tiny_config.codec, dtype=jnp.float32)
    params = weights.params_from_numpy({"codec": host}, device="cpu")["codec"]
    rng = np.random.default_rng(4)
    codes = rng.integers(0, tiny_config.codec.codebook_size, size=(1, 12, 16), dtype=np.int32)
    wav = codec.decode_frames(params, tiny_config.codec, torch.tensor(codes)).numpy()
    want = _golden("tiny_codec_wav.npz")["wav"]
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=2e-5, rtol=0)
