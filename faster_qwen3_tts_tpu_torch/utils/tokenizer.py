"""Text tokenizer plumbing + chat-template builders.

The port's own copy of faster_qwen3_tts_tpu/utils/tokenizer.py (same classes,
same ids).

The reference delegates tokenization and template construction to upstream
`qwen_tts` (`model._tokenize_texts`, `_build_assistant_text`,
`_build_ref_text`, `_build_instruct_text` — SURVEY §2.4). Here the framework
owns them. Two backends:

- `HFTokenizer`: wraps a HuggingFace tokenizer when tokenizer files are
  available next to the checkpoint.
- `ByteTokenizer`: dependency-free fallback (UTF-8 bytes + reserved special
  ids) so the engine, tests, and benchmarks run fully offline.

The prompt-assembly code slices role headers and trailers off tokenized
sequences (the reference hardcodes `input_id[:, :3]`, `[:, 3:-5]`,
`[:, 3:-2]` — reference model.py:686-766). To make those slice semantics hold
by construction, every build_* method returns sequences with EXACTLY:

    assistant text: 3 header ids + text ids + 5 trailer ids
    ref text:       3 header ids + text ids + 2 trailer ids
    instruct text:  3 header ids + text ids + 2 trailer ids
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

ASSISTANT_HEADER_LEN = 3
ASSISTANT_TRAILER_LEN = 5
REF_TRAILER_LEN = 2


class ByteTokenizer:
    """UTF-8 byte tokenizer with a small reserved special-id band.

    ids 0..255: bytes; 256..: special tokens. Vocab fits in the default
    text_vocab_size so random-weight tests and benches need no assets.
    """

    IM_START = 256
    IM_END = 257
    NL = 258
    ROLE_ASSISTANT = 259
    ROLE_USER = 260
    vocab_size = 512

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """HuggingFace tokenizer adapter (used when checkpoint assets exist)."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = int(getattr(tok, "vocab_size", len(tok)))

        def tid(name, fallback):
            i = tok.convert_tokens_to_ids(name)
            return i if i is not None and i >= 0 else fallback

        self.IM_START = tid("<|im_start|>", 151644)
        self.IM_END = tid("<|im_end|>", 151645)
        nl = tok.encode("\n", add_special_tokens=False)
        if len(nl) != 1:
            raise ValueError(
                f"tokenizer encodes '\\n' to {len(nl)} ids ({nl}); the ChatML "
                "role framing the prompt assembly slices (3-id headers, "
                "reference model.py:686-766) requires single-token newlines"
            )
        self.NL = nl[0]
        # Role names MUST be single tokens: the prompt assembly hardcodes
        # 3-id headers ('<|im_start|>' + role + '\n'). A multi-token role
        # would silently shift every slice, so fail loudly instead of
        # truncating to role[0].
        self.ROLE_ASSISTANT = self._single_role_id("assistant")
        self.ROLE_USER = self._single_role_id("user")

    def _single_role_id(self, role: str) -> int:
        ids = self.tok.encode(role, add_special_tokens=False)
        if len(ids) != 1:
            raise ValueError(
                f"tokenizer encodes role {role!r} to {len(ids)} ids ({ids}); "
                "the 3-id ChatML header contract requires single-token role "
                "names (upstream Qwen tokenizers satisfy this)"
            )
        return ids[0]

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tok.decode(ids)


def load_tokenizer(model_path: Optional[str] = None):
    """Load the HF tokenizer from a local checkpoint dir, else ByteTokenizer."""
    if model_path and os.path.isdir(model_path):
        has_assets = any(
            os.path.exists(os.path.join(model_path, f))
            for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json")
        )
        if has_assets:
            try:
                from transformers import AutoTokenizer

                return HFTokenizer(AutoTokenizer.from_pretrained(model_path))
            except Exception:
                pass
    return ByteTokenizer()


class PromptTokenizer:
    """Builds the role-framed id sequences the talker prompt assembly slices.

    Equivalent surface to upstream `_build_assistant_text` + `_tokenize_texts`
    etc. (reference model.py:494-499), but returns ids directly with the
    3/5- and 3/2-token framing guaranteed.
    """

    def __init__(self, base):
        self.base = base

    def _header(self) -> List[int]:
        b = self.base
        return [b.IM_START, b.ROLE_ASSISTANT, b.NL]

    def _user_header(self) -> List[int]:
        b = self.base
        return [b.IM_START, b.ROLE_USER, b.NL]

    def assistant_ids(self, text: str) -> np.ndarray:
        """3 header + text + 5 trailer (`<|im_end|>\\n<|im_start|>assistant\\n`)."""
        b = self.base
        trailer = [b.IM_END, b.NL, b.IM_START, b.ROLE_ASSISTANT, b.NL]
        return np.array([self._header() + b.encode(text) + trailer], dtype=np.int32)

    def ref_ids(self, ref_text: str) -> np.ndarray:
        """3 header + text + 2 trailer (`<|im_end|>\\n`)."""
        b = self.base
        return np.array(
            [self._header() + b.encode(ref_text) + [b.IM_END, b.NL]], dtype=np.int32
        )

    def instruct_ids(self, instruct: str) -> np.ndarray:
        """User-turn instruction prepended before the TTS assistant turn
        (reference model.py:497-499,601-606)."""
        b = self.base
        return np.array(
            [self._user_header() + b.encode(instruct) + [b.IM_END, b.NL]], dtype=np.int32
        )
