"""The `icl` kind of voice (`portbench/voices/icl.py`) and the reference's ICL
layout: the voices are a function of the seed and leave the traffic
generator's stream as it was, the reference's prompt rows equal the
program's `PromptBuilder.build` and `build_device`, and the reference's audio
by the host vocoder's ICL regime equals `model._StreamVocoder.vocode_new`, at
the tiny configuration in float32 on the CPU."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import model as model_lib
from faster_qwen3_tts_tpu_torch.config import config_from_dict
from faster_qwen3_tts_tpu_torch.ops import quant
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer
from portbench import maker, voices
from portbench.reference import model as ref_lib
from portbench.tests import tiny
from portbench.traffic import mix

SEED = 2 ** 31 + 5
MIX = {"median_frames": 48, "sigma": 0.5, "min_frames": 16, "max_frames": 160, "frames_per_token": 3.2,
       "voices": 8, "language": "English"}
ICL = dict(MIX, voice_kind="icl", ref_frames=90)


def test_icl_voices_are_drawn_from_the_seed_and_leave_the_traffic_as_it_was():
    cfg = tiny.tiny_cfg("base")
    kind = voices.of(ICL)
    assert kind.HOST_VOCODER and kind.extra_prompt_rows(ICL) == 90
    a, b = kind.draw(ICL, SEED, cfg), kind.draw(ICL, SEED, cfg)
    assert len(a) == 8
    for va, vb, xv in zip(a, b, voices.of(MIX).draw(MIX, SEED, cfg)):
        assert np.array_equal(va["ref_code"], vb["ref_code"]) and va["ref_text"] == vb["ref_text"]
        assert va["ref_code"].shape == (90, 16) and va["ref_code"].dtype == np.int32
        assert 0 <= va["ref_code"].min() and va["ref_code"].max() < 2048
        assert len(va["ref_text"]) == math.ceil(90 / 3.2) == 29 and va["ref_text"].isascii()
        assert np.array_equal(va["xvector"], xv)  # the x-vector kind's voice of the same index
    assert not np.array_equal(a[0]["ref_code"], kind.draw(ICL, SEED + 1, cfg)[0]["ref_code"])
    assert mix.make(ICL, SEED, 40) == mix.make(MIX, SEED, 40)


@pytest.fixture(scope="module")
def tiny_f32():
    """The tiny configuration's tree in float32 with a 64-wide codec
    decoder, the program's Q8_0 model of it, and the reference."""
    cfg = tiny.tiny_cfg("base")
    cfg["codec"]["decoder_dim"] = 64
    tree = maker.make_tree(cfg, SEED, "cpu", dtype=torch.float32)
    model = model_lib.FasterQwen3TTS(quant.quantize_model_params(tree, "int8"), config_from_dict(cfg),
                                     PromptTokenizer(ByteTokenizer()), max_seq_len=512)
    return cfg, tree, model, ref_lib.Reference(tree, cfg)


@pytest.mark.parametrize("on_device", [False, True], ids=["build", "build_device"])
def test_the_reference_icl_prompt_rows_equal_the_programs(tiny_f32, on_device):
    cfg, _, model, ref = tiny_f32
    kind = voices.of(ICL)
    vs = kind.draw(ICL, SEED, cfg)
    req = {"text": "Abc def ghij", "language": "English", "voice": 2}
    tie, mask, tth, _, ref_codes = model._prepare_generation(req["text"], language="English",
                                                              prefer_device=on_device, **kind.program(vs, req))
    tie, mask, tth = (torch.as_tensor(np.asarray(x)) for x in (tie, mask, tth))
    assert np.array_equal(ref_codes, vs[2]["ref_code"])
    prompt, trailing, pad = ref.prompt({"text": req["text"], "language": "English", **kind.reference(vs, req)},
                                       ref_lib.identity)
    P = int(mask[0].sum())
    assert P == prompt.shape[0] == 3 + 6 + 90 + 1  # role, codec block less its bos, the reference block
    assert torch.allclose(tie[0, -P:].float(), prompt, atol=1e-6, rtol=0)
    n = trailing.shape[0]
    assert n == len(req["text"]) + 1  # the whole text, then tts_eos
    assert torch.allclose(tth[0, :n].float(), trailing, atol=1e-6, rtol=0)
    assert torch.allclose(tth[0, n:].float(), pad.expand(tth.shape[1] - n, -1), atol=1e-6, rtol=0)


def test_the_reference_icl_audio_equals_the_host_vocoder(tiny_f32):
    """Reference codes prepended and their share cut until 24 frames exist,
    then the 24-frame window: every chunk's samples and length."""
    cfg, tree, model, ref = tiny_f32
    rng = np.random.default_rng(1)
    ref_code = rng.integers(0, 2048, (10, 16)).astype(np.int32)
    steps = [4, 8, 8, 8, 8, 3]
    frames = rng.integers(0, 2048, (sum(steps), 16)).astype(np.int32)
    voc = model._make_stream_vocoder(ref_code)
    got, n = [], 0
    for v in steps:
        got.append(voc.vocode_new(frames[n:n + v]))
        n += v
    want = ref.stream_audio(torch.as_tensor(frames), steps, inputs={"ref_code": ref_code})
    assert [len(g) for g in got] == [w.shape[0] for w in want]
    assert [w.shape[0] for w in want][-2:] == [8 * 1920, 3 * 1920]  # past 24 frames: the window rule
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() <= 1e-8
