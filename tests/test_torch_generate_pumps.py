"""tests/test_generate_pumps.py's host-pump edge cases over the port, on the
same weights (the JAX package's host init, seed 0, float32): the exact
`max_new_tokens` trim, the partial final chunk (through
`fast_generate_streaming_fused`: the host-vocoded `fast_generate_streaming`
is not ported), a prefill longer than `max_seq_len` (ValueError in both
packages), the subtalker sampling override, an exact smaller first chunk
and the one static trailing-text bucket. The trimmed stream, the final
chunk's and the smaller first chunk's, run fully greedy, are also held to
the JAX package's codes, exactly; the sampled subtalker override is held
only to the port's own greedy stream."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from faster_qwen3_tts_tpu_torch.prompt import PromptBuilder
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    params = weights.params_from_numpy(host, device="cpu")
    builder = PromptBuilder(params, cfg)
    tok = PromptTokenizer(ByteTokenizer())
    rng = np.random.default_rng(0)
    vcp = dict(ref_code=[None], ref_spk_embedding=[rng.standard_normal(2048).astype(np.float32)],
               x_vector_only_mode=[True], icl_mode=[False])
    tie, tam, tth, tpe = builder.build([tok.assistant_ids("pump test text")], [None], vcp, ["English"], None,
                                       False)
    return host, params, cfg, (tie, tam, tth, tpe)


def test_max_new_tokens_exact_trim(setup):
    """An odd max_new_tokens that the device chunk does not divide is honoured exactly."""
    host, params, cfg, (tie, tam, tth, tpe) = setup
    codes, timing = gen_lib.fast_generate(params, cfg, tie, tam, tth, tpe, max_seq_len=64, max_new_tokens=11,
                                          do_sample=False, seed=0, device_chunk=4)
    assert codes.shape == (11, 16)
    assert timing["steps"] == 11
    assert timing["decode_s"] > 0 and timing["prefill_ms"] > 0
    greedy = dict(max_seq_len=64, max_new_tokens=11, do_sample=False, subtalker_dosample=False, seed=0,
                  device_chunk=4)  # the predictor samples unless told otherwise
    codes, _ = gen_lib.fast_generate(params, cfg, tie, tam, tth, tpe, **greedy)
    want, _ = jax_gen.fast_generate(host, cfg, tie, tam, tth, tpe, **greedy)
    assert codes.shape == (11, 16)
    np.testing.assert_array_equal(codes, np.asarray(want))


def test_streaming_final_chunk_partial(setup):
    """Fully greedy, chunk by chunk equal to the JAX package's streaming frames."""
    host, params, cfg, (tie, tam, tth, tpe) = setup
    greedy = dict(max_seq_len=64, max_new_tokens=10, do_sample=False, subtalker_dosample=False, chunk_size=4,
                  seed=0)
    chunks = list(gen_lib.fast_generate_streaming_fused(params, cfg, tie, tam, tth, tpe, **greedy))
    assert [c[0].shape[0] for c in chunks] == [4, 4, 2]
    assert chunks[-1][2]["is_final"] and not chunks[0][2]["is_final"]
    want = list(jax_gen.fast_generate_streaming(host, cfg, tie, tam, tth, tpe, **greedy))
    assert [w[0].shape[0] for w in want] == [4, 4, 2]
    for (frames, _, _), (jframes, _) in zip(chunks, want):
        np.testing.assert_array_equal(frames, np.asarray(jframes))


def test_prefill_too_long_raises(setup):
    host, params, cfg, (tie, tam, tth, tpe) = setup
    big, mask = np.zeros((1, 80, tie.shape[2]), np.float32), np.ones((1, 80), np.int32)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        gen_lib.fast_generate(params, cfg, big, mask, tth, tpe, max_seq_len=64, max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        jax_gen.fast_generate(host, cfg, big, mask, tth, tpe, max_seq_len=64, max_new_tokens=4)


def test_subtalker_override_changes_codebooks(setup):
    """A greedy talker with a sampled predictor (subtalker_dosample=True) differs
    from the fully greedy stream in codebooks 1-15."""
    _, params, cfg, (tie, tam, tth, tpe) = setup
    greedy, _ = gen_lib.fast_generate(params, cfg, tie, tam, tth, tpe, max_seq_len=64, max_new_tokens=6,
                                      do_sample=False, seed=3, device_chunk=6)
    mixed, _ = gen_lib.fast_generate(params, cfg, tie, tam, tth, tpe, max_seq_len=64, max_new_tokens=6,
                                     do_sample=False, subtalker_dosample=True, subtalker_temperature=5.0, seed=3,
                                     device_chunk=6)
    assert (greedy[:, 1:] != mixed[:, 1:]).any()


def test_first_chunk_size_sample_exact(setup):
    """A smaller fused first chunk gives the same tokens and the same audio
    samples as the uniform-chunk run (same seed); fully greedy, its frames
    equal the JAX package's and its audio is within 1e-4."""
    host, params, cfg, (tie, tam, tth, tpe) = setup

    def run(lib, p, fcs, **kw):
        frames_all, audio_all = [], []
        for frames, audio, _ in lib.fast_generate_streaming_fused(
                p, cfg, tie, tam, tth, tpe, max_seq_len=64, max_new_tokens=12, chunk_size=4, seed=7,
                fuse_first_chunk=True, first_chunk_size=fcs, **kw):
            frames_all.append(np.asarray(frames))
            if audio is not None:
                audio_all.append(np.asarray(audio))
        return np.concatenate(frames_all), np.concatenate(audio_all)

    f_uniform, a_uniform = run(gen_lib, params, None)
    f_small, a_small = run(gen_lib, params, 2)
    np.testing.assert_array_equal(f_uniform, f_small)
    assert a_uniform.shape == a_small.shape
    np.testing.assert_allclose(a_uniform, a_small, atol=1e-4)
    greedy = dict(do_sample=False, subtalker_dosample=False)
    f_port, a_port = run(gen_lib, params, 2, **greedy)
    f_jax, a_jax = run(jax_gen, host, 2, **greedy)
    np.testing.assert_array_equal(f_port, f_jax)
    assert a_port.shape == a_jax.shape
    np.testing.assert_allclose(a_port, a_jax, atol=1e-4, rtol=0)


def test_tth_bucket_static_single_executable_shape(setup):
    """Texts of different lengths land in one static trailing-text bucket."""
    import os

    cap = int(os.environ.get("FQ3T_TTH_BUCKET", "256"))
    assert gen_lib.tth_bucket(1) == cap
    assert gen_lib.tth_bucket(cap) == cap
    assert gen_lib.tth_bucket(cap + 1) == 2 * cap  # powers of two past it
    _, params, cfg, _ = setup
    builder = PromptBuilder(params, cfg)
    tok = PromptTokenizer(ByteTokenizer())
    vcp = dict(ref_code=[None], ref_spk_embedding=[np.zeros(2048, np.float32)], x_vector_only_mode=[True],
               icl_mode=[False])
    shapes = set()
    for text in ("ab", "short but longer text"):  # both under the test bucket cap
        tie, tam, tth, tpe = builder.build([tok.assistant_ids(text)], [None], vcp, ["English"], None, False)
        sess = gen_lib.GenerationSession(params, cfg, tie, tam, tth, tpe, 64, SamplingParams(),
                                         gen_lib.predictor_sampling(), 2, seed=0)
        shapes.add(tuple(sess.tth.shape))
        sess.close()
    assert len(shapes) == 1, shapes
