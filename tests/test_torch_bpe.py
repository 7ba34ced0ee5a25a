"""The port's byte-level BPE reader (`utils/bpe.py`) against `AutoTokenizer`,
exactly, on both committed fixture layouts: `tests/fixtures/qwen_tokenizer`
(a `tokenizer.json` with GPT-2's byte-level split) and
`tests/torch_fixtures/qwen2_tokenizer` (`vocab.json` + `merges.txt` + a
`Qwen2Tokenizer` config: NFC, Qwen2's split, byte level), plus variants
written here (Qwen2's pipeline saved as a `tokenizer.json`, normalized and
overlapping added tokens, `added_tokens.json`, a special token the config
names but does not add).

Texts: the fixed texts of `tests/torch_fixtures/tokenizer_expected.json`
(its ids and decodes were written by `AutoTokenizer`, and a fresh run must
give them again), and a sweep of 500 strings drawn with
`numpy.random.default_rng(0)` from the assigned code points of planes 0-1
(half of the characters from a pool of ASCII, whitespace, contractions and
the ChatML specials, half from every assigned code point). The translated
split patterns are held to the `regex` module's on the same sweep; every
refusal raises `UnsupportedTokenizer`."""
import importlib.util
import json
import shutil
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest

from faster_qwen3_tts_tpu_torch.utils import bpe
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer

REPO = Path(__file__).resolve().parent.parent
EXPECTED = json.loads((REPO / "tests" / "torch_fixtures" / "tokenizer_expected.json").read_text())
FIXTURES = {name: REPO / f["path"] for name, f in EXPECTED["fixtures"].items()}
QWEN, QWEN2 = FIXTURES["qwen_tokenizer"], FIXTURES["qwen2_tokenizer"]
TEXTS = EXPECTED["texts"]
COMMON = (list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 '\"!?.,;:-()\n\r\t")
          + ["\x1c", "\x1f", "\u00a0", "\u3000", "\u0085", "\u2009", "\u017f", "\u00e9", "e\u0301", "'s", "'S",
             "'ll", "'RE", "  ", "\r\n", "<|im_start|>", "<|im_end|>", "<|endoftext|>"])


def _sweep(n=500, seed=0):
    rng = np.random.default_rng(seed)
    assigned = np.array([c for c in range(0x20000) if unicodedata.category(chr(c)) not in ("Cn", "Cs")])
    out = []
    for _ in range(n):
        chars = []
        for _ in range(int(rng.integers(1, 40))):
            if rng.random() < 0.5:
                chars.append(COMMON[int(rng.integers(len(COMMON)))])
            else:
                chars.append(chr(int(assigned[int(rng.integers(len(assigned)))])))
        out.append("".join(chars))
    return out


SWEEP = _sweep()


def _builder():
    spec = importlib.util.spec_from_file_location(
        "build_qwen2_tokenizer", REPO / "tests" / "torch_fixtures" / "build_qwen2_tokenizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def readers():
    return {name: bpe.read_tokenizer(path) for name, path in FIXTURES.items()}


def _auto(path):
    transformers = pytest.importorskip("transformers")
    return transformers.AutoTokenizer.from_pretrained(str(path))


@pytest.mark.parametrize("index", range(len(TEXTS)))
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_gives_the_committed_ids(readers, name, index):
    want = EXPECTED["fixtures"][name]
    tok = readers[name]
    assert tok.encode(TEXTS[index], add_special_tokens=False) == want["ids"][index]
    assert tok.decode(want["ids"][index]) == want["decoded"][index]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_surface_matches_autotokenizer(readers, name):
    ref, tok = _auto(FIXTURES[name]), readers[name]
    assert tok.vocab_size == ref.vocab_size == EXPECTED["fixtures"][name]["vocab_size"]
    assert len(tok) == len(ref) == EXPECTED["fixtures"][name]["len"]
    names = ["<|im_start|>", "<|im_end|>", "<|endoftext|>", "assistant", "user", "Ċ", "no such token"]
    assert [tok.convert_tokens_to_ids(n) for n in names] == [ref.convert_tokens_to_ids(n) for n in names]
    assert tok.convert_tokens_to_ids("no such token") is None
    wrapped, theirs = HFTokenizer(tok), HFTokenizer(ref)
    for attr in ("vocab_size", "IM_START", "IM_END", "NL", "ROLE_ASSISTANT", "ROLE_USER"):
        assert getattr(wrapped, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reader_matches_autotokenizer_on_the_sweep(readers, name):
    ref, tok = _auto(FIXTURES[name]), readers[name]
    for text in SWEEP:
        ids = ref.encode(text, add_special_tokens=False)
        assert tok.encode(text) == ids, repr(text)
        assert tok.decode(ids) == ref.decode(ids), repr(text)
    # any id sequence, cut UTF-8 included (replaced), out-of-range ids dropped
    rng = np.random.default_rng(1)
    for _ in range(300):
        ids = rng.integers(0, len(ref) + 2, size=int(rng.integers(1, 12))).tolist()
        assert tok.decode(ids) == ref.decode(ids), ids
    assert [tok.decode([i]) for i in range(len(ref))] == [ref.decode([i]) for i in range(len(ref))]


@pytest.mark.parametrize("pattern", ["GPT2_PATTERN", "QWEN2_PATTERN"])
def test_translated_split_matches_the_regex_module(pattern):
    regex = pytest.importorskip("regex")
    source = getattr(bpe, pattern)
    ours = bpe.split_regex(source)
    for text in SWEEP + TEXTS:
        assert bpe.split_isolated(ours, text) == regex.findall(source, text), repr(text)


def test_white_space_class_is_unicode_white_space():
    """`re`'s \\s takes U+001C-U+001F; White_Space (what the split means) does not."""
    import re

    ws = re.compile(f"[{bpe.unicode_classes()['s']}]")
    for c in "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u200a\u2028\u2029\u202f\u205f\u3000":
        assert ws.match(c), hex(ord(c))
    for c in "\x1c\x1d\x1e\x1f\u180e\u200b\ufeffa1_":
        assert not ws.match(c), hex(ord(c))
        assert bpe.split_isolated(bpe.split_regex(bpe.QWEN2_PATTERN), f"x{c}{c} y")[-1] == " y"


def test_unicode_classes_match_tokenizers():
    """On every code point assigned in Python's Unicode version, the
    translated `\\p{L}`, `\\p{N}` and `\\s` match what `tokenizers`' own
    regex engine matches. (Where `tokenizers` has a newer Unicode, code
    points unassigned here may be letters or digits there; ROADMAP.md
    section C lists them.)"""
    import re

    tokenizers = pytest.importorskip("tokenizers")
    cps = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
    text = "".join(map(chr, cps))
    assigned = {c for c in cps if unicodedata.category(chr(c)) != "Cn"}
    classes = bpe.unicode_classes()
    for key, runs in (("L", r"[^\p{L}]+"), ("N", r"[^\p{N}]+"), ("s", r"\S+")):
        split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(runs), behavior="removed")
        theirs = {ord(ch) for piece, _ in split.pre_tokenize_str(text) for ch in piece}
        ours = {cps[m.start()] for m in re.finditer(f"[{classes[key]}]", text)}
        assert ours & assigned == theirs & assigned, key
        assert ours <= theirs, key


def test_committed_files_are_fresh():
    """The committed Qwen2 layout and expected ids are what the builder
    writes now (a stale file fails)."""
    pytest.importorskip("transformers")
    build = _builder()
    assert build.TEXTS == TEXTS
    for fname, text in build.qwen2_layout().items():
        assert (QWEN2 / fname).read_text() == text, fname
    assert build.expected() == EXPECTED


# -- variants written here, each held to AutoTokenizer ---------------------------------------------

def _saved_qwen2_json(tmp):
    """Qwen2's pipeline saved by transformers as a tokenizer.json (layout (a) with NFC and the Split)."""
    _auto(QWEN2).save_pretrained(str(tmp))
    spec = json.loads((tmp / "tokenizer.json").read_text())
    assert spec["normalizer"]["type"] == "NFC" and spec["pre_tokenizer"]["type"] == "Sequence"
    return tmp


def _normalized_added(tmp):
    from transformers import AddedToken

    ref = _auto(QWEN2)
    ref.add_tokens([AddedToken("ca\u0301t", normalized=True), AddedToken("big dog", normalized=False),
                    AddedToken("big", normalized=False), AddedToken("qu", normalized=True)])
    ref.save_pretrained(str(tmp))
    return tmp


def _added_tokens_json(tmp):
    shutil.copytree(QWEN2, tmp, dirs_exist_ok=True)
    cfg = json.loads((tmp / "tokenizer_config.json").read_text())
    del cfg["added_tokens_decoder"]
    (tmp / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp / "added_tokens.json").write_text(json.dumps({"<|endoftext|>": 404, "<|im_start|>": 405,
                                                       "<|im_end|>": 406, "<extra>": 407}))
    return tmp


def _special_not_added(tmp):
    """The config names an eos the added tokens lack, and leaves unk to the class default."""
    shutil.copytree(QWEN2, tmp, dirs_exist_ok=True)
    cfg = json.loads((tmp / "tokenizer_config.json").read_text())
    del cfg["unk_token"]
    cfg["eos_token"] = "<|eos|>"
    (tmp / "tokenizer_config.json").write_text(json.dumps(cfg))
    return tmp


VARIANTS = {"qwen2_saved_as_tokenizer_json": _saved_qwen2_json, "normalized_added_token": _normalized_added,
            "added_tokens_json": _added_tokens_json,
            "special_not_added": _special_not_added}
EXTRA_TEXTS = ["a cat, c\u00e1t and ca\u0301t; big dog big  dog quqU <extra> <|eos|> <|endoftext|> .",
               "x , y ' z n't"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_autotokenizer(variant, tmp_path):
    pytest.importorskip("transformers")
    path = VARIANTS[variant](tmp_path)
    ref, tok = _auto(path), bpe.read_tokenizer(path)
    assert (tok.vocab_size, len(tok)) == (ref.vocab_size, len(ref))
    for name in ("<|eos|>", "<extra>", "big dog", "no such token"):
        assert tok.convert_tokens_to_ids(name) == ref.convert_tokens_to_ids(name), name
    for text in TEXTS + EXTRA_TEXTS + SWEEP[:100]:
        ids = ref.encode(text, add_special_tokens=False)
        assert tok.encode(text) == ids, repr(text)
        assert tok.decode(ids) == ref.decode(ids), repr(text)


# -- refusals ------------------------------------------------------------------------------------------

def _edit_json(path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def _model(fn):
    return lambda d: _edit_json(d / "tokenizer.json", lambda t: fn(t["model"]))


def _tok(fn):
    return lambda d: _edit_json(d / "tokenizer.json", fn)


def _cfg(fn):
    return lambda d: _edit_json(d / "tokenizer_config.json", fn)


def _first_added(key):
    return _tok(lambda t: t["added_tokens"][0].update({key: True}))


REFUSALS = {  # name -> (fixture, edit of its copy)
    "model_wordpiece": (QWEN, _model(lambda m: m.update(type="WordPiece"))),
    "byte_fallback": (QWEN, _model(lambda m: m.update(byte_fallback=True))),
    "dropout": (QWEN, _model(lambda m: m.update(dropout=0.1))),
    "continuing_subword_prefix": (QWEN, _model(lambda m: m.update(continuing_subword_prefix="##"))),
    "end_of_word_suffix": (QWEN, _model(lambda m: m.update(end_of_word_suffix="</w>"))),
    "unk_token_in_model": (QWEN, _model(lambda m: m.update(unk_token="a"))),
    "ignore_merges": (QWEN, _model(lambda m: m.update(ignore_merges=True))),
    "added_lstrip": (QWEN, _first_added("lstrip")),
    "added_rstrip": (QWEN, _first_added("rstrip")),
    "added_single_word": (QWEN, _first_added("single_word")),
    "normalizer_nfkc": (QWEN, _tok(lambda t: t.update(normalizer={"type": "NFKC"}))),
    "normalizer_lowercase": (QWEN, _tok(lambda t: t.update(normalizer={"type": "Sequence", "normalizers": [
        {"type": "NFC"}, {"type": "Lowercase"}]}))),
    "pre_tokenizer_metaspace": (QWEN, _tok(lambda t: t.update(pre_tokenizer={"type": "Metaspace"}))),
    "byte_level_prefix_space": (QWEN, _tok(lambda t: t["pre_tokenizer"].update(add_prefix_space=True))),
    "byte_level_without_split": (QWEN, _tok(lambda t: t["pre_tokenizer"].update(use_regex=False))),
    "split_other_pattern": (QWEN, _tok(lambda t: t.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": r"\p{Lu}+|\s+"}, "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]}))),
    "split_removed": (QWEN, _tok(lambda t: t.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": bpe.QWEN2_PATTERN}, "behavior": "Removed", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]}))),
    "decoder_wordpiece": (QWEN, _tok(lambda t: t.update(decoder={"type": "WordPiece"}))),
    "post_processor_template": (QWEN, _tok(lambda t: t.update(post_processor={"type": "TemplateProcessing"}))),
    "merge_not_a_pair": (QWEN, _model(lambda m: m["merges"].append(["a", "b", "c"]))),
    "merge_out_of_vocabulary": (QWEN, _model(lambda m: m["merges"].append("é é"))),
    "merge_twice": (QWEN, _model(lambda m: m["merges"].append(m["merges"][0]))),
    "vocab_not_a_map": (QWEN, _model(lambda m: m.update(vocab=["a", "b"]))),
    "vocab_shared_id": (QWEN, _model(lambda m: m["vocab"].update({"ĀĀĀ": 0}))),
    "tokenizer_json_malformed": (QWEN, lambda d: (d / "tokenizer.json").write_text("{\"model\": ")),
    "tokenizer_json_empty": (QWEN, lambda d: (d / "tokenizer.json").write_text("{}")),
    "class_llama": (QWEN, _cfg(lambda c: c.update(tokenizer_class="LlamaTokenizerFast"))),
    "no_class": (QWEN, _cfg(lambda c: c.pop("tokenizer_class"))),
    "no_config": (QWEN, lambda d: (d / "tokenizer_config.json").unlink()),
    "split_special_tokens": (QWEN2, _cfg(lambda c: c.update(split_special_tokens=True))),
    "clean_up_tokenization_spaces": (QWEN, _cfg(lambda c: c.update(clean_up_tokenization_spaces=True))),
    "add_prefix_space": (QWEN2, _cfg(lambda c: c.update(add_prefix_space=True))),
    "layout_b_class_gpt2": (QWEN2, _cfg(lambda c: c.update(tokenizer_class="GPT2Tokenizer"))),
    "layout_b_no_merges": (QWEN2, lambda d: (d / "merges.txt").unlink()),
    "merges_txt_three_parts": (QWEN2, lambda d: (d / "merges.txt").write_text("#version: 0.2\na b c\n")),
    "vocab_json_malformed": (QWEN2, lambda d: (d / "vocab.json").write_text("[")),
    "added_tokens_decoder_bad_key": (QWEN2, _cfg(lambda c: c["added_tokens_decoder"].update(x={"content": "y"}))),
    "added_tokens_decoder_lstrip": (QWEN2, _cfg(lambda c: c["added_tokens_decoder"]["405"].update(lstrip=True))),
    "added_token_redefined": (QWEN, _cfg(lambda c: c.update(added_tokens_decoder={"405": {
        "content": "<|im_start|>", "normalized": True}}))),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_unsupported_tokenizer(case, tmp_path):
    fixture, edit = REFUSALS[case]
    shutil.copytree(fixture, tmp_path, dirs_exist_ok=True)
    edit(tmp_path)
    with pytest.raises(bpe.UnsupportedTokenizer):
        bpe.read_tokenizer(tmp_path)


# -- load_tokenizer: the reader, else the byte tokenizer ----------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_load_tokenizer_picks_the_reader(name):
    tok = load_tokenizer(str(FIXTURES[name]))
    assert isinstance(tok, HFTokenizer) and isinstance(tok.tok, bpe.BPETokenizer)


def test_load_tokenizer_refused_assets_fall_back_to_bytes(tmp_path):
    """A layout the reader refuses (ignore_merges) gets the byte tokenizer
    and the refusal as its reason; `transformers` is not tried."""
    shutil.copytree(QWEN, tmp_path, dirs_exist_ok=True)
    REFUSALS["ignore_merges"][1](tmp_path)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, ByteTokenizer)
    assert "refused" in tok.fallback_reason and "ignore_merges" in tok.fallback_reason


def test_load_tokenizer_needs_no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    monkeypatch.setitem(sys.modules, "regex", None)
    for path in FIXTURES.values():
        assert isinstance(load_tokenizer(str(path)).tok, bpe.BPETokenizer)


@pytest.mark.parametrize("files", [{}, {"tokenizer.json": "{}", "tokenizer_config.json": "{}"},
                                   {"tokenizer_config.json": "not json"}, {"vocab.json": "{}"}],
                         ids=["none", "empty_json", "malformed", "vocab_only"])
def test_load_tokenizer_never_raises(files, tmp_path):
    for fname, text in files.items():
        (tmp_path / fname).write_text(text)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, ByteTokenizer) and tok.fallback_reason
    assert ("no tokenizer assets" in tok.fallback_reason) == (not files)
    assert isinstance(load_tokenizer(None), ByteTokenizer) and load_tokenizer(None).fallback_reason is None
