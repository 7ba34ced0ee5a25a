"""Build the Qwen2-layout tokenizer fixture and the expected ids of both
fixtures (run once, output committed; needs `transformers`).

Qwen checkpoints ship their tokenizer as `vocab.json` + `merges.txt` + a
`tokenizer_config.json` with `tokenizer_class: Qwen2Tokenizer` and the
ChatML specials in `added_tokens_decoder`. From those files `transformers`
builds another pipeline than the one of tests/fixtures/qwen_tokenizer's
`tokenizer.json` (GPT-2's byte-level split): NFC, then Qwen2's split
pattern (one digit a piece, case-insensitive contractions, newline runs),
then byte level. This script writes that layout from the committed
fixture's own vocabulary and merges:

    tests/torch_fixtures/qwen2_tokenizer/{vocab.json,merges.txt,tokenizer_config.json}

and `tests/torch_fixtures/tokenizer_expected.json`: for each fixture, the
ids `AutoTokenizer.encode(text, add_special_tokens=False)` gives for every
text of TEXTS and the text `decode` gives back. tests/test_torch_tokenizer_fixture.py
holds the port's `load_tokenizer` and a fresh `AutoTokenizer` run to both, and
`chip_smoke.py` holds the card's.

    python tests/torch_fixtures/build_qwen2_tokenizer.py
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).parent
REPO = HERE.parent.parent
SOURCE = REPO / "tests" / "fixtures" / "qwen_tokenizer"
OUT = HERE / "qwen2_tokenizer"
EXPECTED = HERE / "tokenizer_expected.json"
FIXTURES = {"qwen_tokenizer": "tests/fixtures/qwen_tokenizer",
            "qwen2_tokenizer": "tests/torch_fixtures/qwen2_tokenizer"}

# the fixed texts: ASCII, contractions in both cases, composed and decomposed
# accents, CJK, digit runs, emoji with ZWJ sequences, runs of spaces, tabs,
# \r\n, trailing whitespace, punctuation before newlines, ChatML specials
# inside text, the code points where `re`'s \s and White_Space part
# (U+001C-U+001F) and other White_Space, the empty string
TEXTS = [
    "The quick brown fox jumps over the lazy dog today.",
    "Hello world, 12345 it's…",
    "I'm sure they'll say we'd've done it; it's theirs, isn't it?",
    "IT'S WE'RE THEY'VE I'LL HE'D I'M DON'T It'S We'Re",
    "it'ſ a long s, and 'sup 'twas 'em",
    "Grüße aus Köln — ça va? café naïve",
    "cafe\u0301 Ko\u0308ln nai\u0308ve A\u030a \u1e9b\u0323 and café",
    "你好，世界。日本語のテキスト、한국어 텍스트",
    "0123456789 3.14159 1,000,000 2024-06-01 ٣٤٥ ①② ½ x²",
    "\U0001f44b\U0001f3fd \U0001f468\u200d\U0001f469\u200d\U0001f467\u200d\U0001f466 \U0001f3f3\ufe0f\u200d\U0001f308 \u2764\ufe0f \U0001f1e9\U0001f1ea!",
    "a  b   c    d     e",
    "\tx\t\ty \t z",
    "line one\r\nline two\r\n\r\nline four\n\n\nend",
    "trailing spaces   ",
    "  leading and trailing \n ",
    "Wait...\n\nWhat?!\n(quoted) \"text\"!!\r\n--\n",
    "<|im_start|>assistant\nHello there.<|im_end|>\n<|im_start|>assistant\n",
    "a<|im_start|>b<|im_end|>c<|endoftext|> <|im_end|>x",
    "a\x1cb\x1dc\x1e d\x1f e \x1c\x1c f",
    "x\u00a0y\u2009z\u3000w\u2028v\u2029u\u0085t\u180es\u200bq\u202fp\u205fo\u000bn\u000cm\u1680l",
    "Привет, мир! Γειά σου مرحبا שלום नमस्ते",
    "speech synthesis reference audio text prompt",
    "\n",
    " ",
    "",
]


def qwen2_layout() -> dict:
    """The Qwen2-layout files (name -> text) from the committed fixture's
    vocabulary, merges and ChatML specials."""
    tok = json.loads((SOURCE / "tokenizer.json").read_text())
    model = tok["model"]
    merges = [m if isinstance(m, str) else " ".join(m) for m in model["merges"]]
    src_cfg = json.loads((SOURCE / "tokenizer_config.json").read_text())
    cfg = {
        "tokenizer_class": "Qwen2Tokenizer",
        "added_tokens_decoder": {
            str(t["id"]): {"content": t["content"], "lstrip": False, "normalized": False, "rstrip": False,
                           "single_word": False, "special": True}
            for t in tok["added_tokens"]
        },
        "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
        "bos_token": None,
        "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>",
        "unk_token": None,
        "chat_template": src_cfg["chat_template"],
        "clean_up_tokenization_spaces": False,
        "errors": "replace",
        "split_special_tokens": False,
        "model_max_length": 131072,
    }
    return {"vocab.json": json.dumps(model["vocab"], ensure_ascii=False, indent=1),
            "merges.txt": "#version: 0.2\n" + "\n".join(merges) + "\n",
            "tokenizer_config.json": json.dumps(cfg, indent=1)}


def expected() -> dict:
    """AutoTokenizer's ids and decodes of TEXTS for both fixtures."""
    from transformers import AutoTokenizer

    out = {"texts": TEXTS, "fixtures": {}}
    for name, rel in FIXTURES.items():
        tok = AutoTokenizer.from_pretrained(str(REPO / rel))
        ids = [tok.encode(t, add_special_tokens=False) for t in TEXTS]
        out["fixtures"][name] = {"path": rel, "class": type(tok).__name__, "vocab_size": tok.vocab_size,
                                 "len": len(tok), "ids": ids, "decoded": [tok.decode(i) for i in ids]}
    return out


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, text in qwen2_layout().items():
        (OUT / name).write_text(text)
    EXPECTED.write_text(json.dumps(expected(), ensure_ascii=False, indent=1) + "\n")
    print("wrote", OUT, "and", EXPECTED)


if __name__ == "__main__":
    main()
