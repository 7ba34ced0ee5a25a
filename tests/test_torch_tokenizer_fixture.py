"""tests/test_tokenizer_fixture.py's cases over the port: `load_tokenizer`
now returns the port's BPE reader (`utils/bpe.py`), for both committed
fixture layouts (`tests/fixtures/qwen_tokenizer`, a tokenizer.json, and
`tests/torch_fixtures/qwen2_tokenizer`, vocab.json + merges.txt + a
Qwen2Tokenizer config). `PromptTokenizer` over the reader must give the
framing `AutoTokenizer` gives (the literal ChatML strings and
`apply_chat_template`), with the 3/5/2 header and trailer lengths.

Then one stream across the packages: a tiny checkpoint written by the JAX
package with the Qwen2 fixture copied in, loaded by the JAX package (whose
tokenizer is `AutoTokenizer`) and by the port (whose tokenizer is the
reader): equal prompt ids, equal greedy x-vector codes, audio within 1e-4."""
import dataclasses
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch.utils import bpe
from faster_qwen3_tts_tpu_torch.utils.tokenizer import (
    ASSISTANT_HEADER_LEN, ASSISTANT_TRAILER_LEN, REF_TRAILER_LEN,
    HFTokenizer, PromptTokenizer, load_tokenizer,
)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = {"qwen_tokenizer": REPO / "tests" / "fixtures" / "qwen_tokenizer",
            "qwen2_tokenizer": REPO / "tests" / "torch_fixtures" / "qwen2_tokenizer"}
TEXT = "The quick brown fox jumps over the lazy dog today."
NAMES = sorted(FIXTURES)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(AutoTokenizer, the port's PromptTokenizer over load_tokenizer) of one fixture."""
    path = str(FIXTURES[request.param])
    base = load_tokenizer(path)
    return transformers.AutoTokenizer.from_pretrained(path), PromptTokenizer(base)


@pytest.mark.parametrize("name", NAMES)
def test_load_tokenizer_picks_the_reader(name):
    tok = load_tokenizer(str(FIXTURES[name]))
    assert isinstance(tok, HFTokenizer) and isinstance(tok.tok, bpe.BPETokenizer)
    assert tok.IM_START != tok.IM_END


def test_assistant_framing_matches_chat_template(pair):
    hf_tok, prompt_tok = pair
    ids = prompt_tok.assistant_ids(TEXT)[0].tolist()
    rendered = hf_tok.apply_chat_template([{"role": "assistant", "content": TEXT}], add_generation_prompt=True)
    assert ids == rendered


def test_assistant_framing_matches_literal_string(pair):
    hf_tok, prompt_tok = pair
    ids = prompt_tok.assistant_ids(TEXT)[0].tolist()
    want = hf_tok.encode(f"<|im_start|>assistant\n{TEXT}<|im_end|>\n<|im_start|>assistant\n",
                         add_special_tokens=False)
    assert ids == want
    text_ids = hf_tok.encode(TEXT, add_special_tokens=False)
    assert ids[:ASSISTANT_HEADER_LEN] + text_ids + ids[-ASSISTANT_TRAILER_LEN:] == ids


def test_ref_framing_matches_literal_string(pair):
    hf_tok, prompt_tok = pair
    ref = "Hello world, this is a voice cloning test sentence."
    ids = prompt_tok.ref_ids(ref)[0].tolist()
    assert ids == hf_tok.encode(f"<|im_start|>assistant\n{ref}<|im_end|>\n", add_special_tokens=False)
    assert len(ids) == ASSISTANT_HEADER_LEN + len(hf_tok.encode(ref, add_special_tokens=False)) + REF_TRAILER_LEN


def test_instruct_framing_is_user_turn(pair):
    hf_tok, prompt_tok = pair
    instr = "Please read this in a calm and friendly tone."
    ids = prompt_tok.instruct_ids(instr)[0].tolist()
    assert ids == hf_tok.apply_chat_template([{"role": "user", "content": instr}], add_generation_prompt=False)


def test_round_trip_text(pair):
    _, prompt_tok = pair
    tok = prompt_tok.base
    for text in (TEXT, "It's 12345 o'clock,\r\n  naïve café — 你好!"):
        assert tok.decode(tok.encode(text)) == text


def test_fixture_specials_never_split(pair):
    hf_tok, prompt_tok = pair
    ids = prompt_tok.base.encode("a<|im_start|>b")
    assert prompt_tok.base.IM_START in ids and ids == hf_tok.encode("a<|im_start|>b", add_special_tokens=False)


def test_prompt_assembly_slices_align(pair):
    """The exact slices upstream hardcodes ([:, :3], [:, 3:-5]) recover the text."""
    hf_tok, prompt_tok = pair
    ids = prompt_tok.assistant_ids(TEXT)[0]
    np.testing.assert_array_equal(ids[ASSISTANT_HEADER_LEN:-ASSISTANT_TRAILER_LEN],
                                  np.asarray(hf_tok.encode(TEXT, add_special_tokens=False)))


def test_multi_token_role_hard_errors():
    class FakeTok:
        vocab_size = 100

        def __len__(self):
            return 100

        def convert_tokens_to_ids(self, name):
            return {"<|im_start|>": 90, "<|im_end|>": 91}.get(name, -1)

        def encode(self, text, add_special_tokens=False):
            return [5] if text == "\n" else [1, 2]  # every role name splits into two ids

    with pytest.raises(ValueError, match="role 'assistant'"):
        HFTokenizer(FakeTok())


def test_multi_token_newline_hard_errors():
    class FakeTok:
        vocab_size = 100

        def __len__(self):
            return 100

        def convert_tokens_to_ids(self, name):
            return 90

        def encode(self, text, add_special_tokens=False):
            return [1, 2]

    with pytest.raises(ValueError, match="newline"):
        HFTokenizer(FakeTok())


# -- one stream across the packages ------------------------------------------------------------------

def _stream(model, prompt, text, frames):
    relay, tokens = model._stream_decode, []

    def tap(stream, *a):
        def inner():
            for item in stream:
                tokens.append(np.asarray(item[0]))
                yield item
        return relay(inner(), *a)

    model._stream_decode = tap
    audio = [a for a, _, _ in model.generate_voice_clone_streaming(
        text, "English", voice_clone_prompt=prompt, max_new_tokens=frames, chunk_size=8, first_chunk_size=4,
        do_sample=False, subtalker_dosample=False, seed=0)]
    return np.concatenate(tokens), np.concatenate(audio)


def test_checkpoint_with_the_qwen2_fixture_streams_as_jax(tiny_config, tmp_path):
    from faster_qwen3_tts_tpu import weights as jw
    from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
    from faster_qwen3_tts_tpu.utils.tokenizer import HFTokenizer as JaxHFTokenizer
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=450, tts_eos_token_id=451, tts_pad_token_id=452)
    jw.save_pretrained(str(tmp_path), jw.init_all(cfg, seed=7, dtype=jnp.float32, device_put=False), cfg)
    shutil.copytree(FIXTURES["qwen2_tokenizer"], tmp_path, dirs_exist_ok=True)
    jm = JaxTTS.from_pretrained(str(tmp_path), dtype="float32", max_seq_len=128)
    jm._warmed_up = True
    pm = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", dtype="float32", max_seq_len=128)
    assert isinstance(jm.tokenizer.base, JaxHFTokenizer) and not isinstance(jm.tokenizer.base.tok, bpe.BPETokenizer)
    assert isinstance(pm.tokenizer.base.tok, bpe.BPETokenizer)
    text = "It's 12345 o'clock, naïve café.\r\nTHEY'LL say: wait…"
    for method, arg in (("assistant_ids", text), ("ref_ids", text), ("instruct_ids", "Calm.")):
        want = getattr(jm.tokenizer, method)(arg)
        np.testing.assert_array_equal(getattr(pm.tokenizer, method)(arg), want)
    assert max(jm.tokenizer.assistant_ids(text)[0]) < cfg.talker.text_vocab_size
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    jt, ja = _stream(jm, prompt, text, 20)
    pt, pa = _stream(pm, prompt, text, 20)
    np.testing.assert_array_equal(pt, jt)
    assert pa.shape == ja.shape
    np.testing.assert_allclose(pa, ja, atol=1e-4, rtol=0)
