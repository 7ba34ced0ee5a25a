"""A checkpoint's byte-level BPE tokenizer, read without `transformers`,
`tokenizers` or `regex`.

It gives the ids `AutoTokenizer` gives on a Qwen checkpoint's tokenizer
assets without importing `transformers` (on an H100 host with
`transformers` 5.5, a fresh process took 14-16 s to load a tokenizer
through `AutoTokenizer`, 0.3 s through this reader and about 2 s to load a
whole deploy bundle: tools/tokenizer_load_cost.py). It reads two layouts:

- (a) `tokenizer.json` with a `BPE` model (a `tokenizers` pipeline), beside a
  `tokenizer_config.json` whose class is `PreTrainedTokenizerFast` or
  `Qwen2Tokenizer[Fast]`;
- (b) `vocab.json` + `merges.txt` + a `tokenizer_config.json` whose class is
  `Qwen2Tokenizer[Fast]`: the pipeline `Qwen2TokenizerFast` builds from them
  (NFC, the Qwen2 split pattern, byte level), with the added tokens of
  `added_tokens_decoder` (or, without it, of `added_tokens.json`).

Encoding runs the `tokenizers` pipeline: the text is split on the added
tokens (leftmost, longest first; those marked `normalized` are matched after
the normalizer), the other segments are normalized (none or NFC) and split
by the pre-tokenizer's pattern (each match and each gap a piece), each piece
is mapped byte by byte to GPT-2's printable alphabet and merged by merge
rank, and the symbols are looked up in the vocabulary. Added tokens take the
ids `tokenizers` gives them: a token of the vocabulary keeps its id, any
other the next id after the vocabulary and the tokens added before it.

The split patterns use `\\p{L}`, `\\p{N}` and `\\s`. The standard `re` lacks
the first two, and its `\\s` also takes U+001C-U+001F, which Unicode's
White_Space (what `tokenizers` matches) does not. So each is translated into
an explicit class of code point ranges, built once from `unicodedata`: the
ranges follow Python's Unicode version, so a code point unassigned there that
is a letter or digit in the tables of `tokenizers` is split otherwise.

Anything outside this set, and any malformed file, raises
`UnsupportedTokenizer`; `utils.tokenizer.load_tokenizer` then falls back to
the byte tokenizer, with the reason.
"""
from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# GPT-2's pattern (`ByteLevel(use_regex=True)`) and the split `Qwen2TokenizerFast` builds
GPT2_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
QWEN2_PATTERN = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
                 r"""|\s*[\r\n]+|\s+(?!\S)|\s+""")
QWEN2_CLASSES = ("Qwen2Tokenizer", "Qwen2TokenizerFast")
# the special tokens each class sets where tokenizer_config.json does not name them
_CLASS_SPECIALS = {"PreTrainedTokenizerFast": {},
                   **{c: {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                          "pad_token": "<|endoftext|>"} for c in QWEN2_CLASSES}}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_CACHE_WORDS = 10000


class UnsupportedTokenizer(ValueError):
    """The assets are not a byte-level BPE pipeline this reader reproduces
    (or are malformed); the message says why."""


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.lru_cache(maxsize=None)
def unicode_classes() -> Dict[str, str]:
    """The bodies of `[...]` classes for `\\p{L}`, `\\p{N}` and White_Space
    (the Zs, Zl and Zp categories, U+0009-U+000D and U+0085), as code point
    ranges in `\\U` escapes, from `unicodedata`."""
    major = "".join(map(unicodedata.category, map(chr, range(0x110000))))[::2]

    def spans(letter):
        return [m.span() for m in re.finditer(f"{letter}+", major)]

    def body(ranges):
        return "".join(_esc(a) if b == a + 1 else f"{_esc(a)}-{_esc(b - 1)}" for a, b in sorted(ranges))

    return {"L": body(spans("L")), "N": body(spans("N")), "s": body(spans("Z") + [(0x09, 0x0E), (0x85, 0x86)])}


def translate(pattern: str) -> str:
    """A `tokenizers` split pattern -> the same pattern for `re`: `\\p{L}`,
    `\\p{N}` and `\\s` become explicit classes (inside a class, their ranges),
    `\\S` outside a class the negated White_Space class. Other escapes than
    `\\r`, `\\n` and `\\t` are refused."""
    cls = unicode_classes()
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            rest = pattern[i + 1:]
            key = next((k for k in ("p{L}", "p{N}", "s", "S") if rest.startswith(k)), None)
            if key is None:
                if rest[:1] not in ("r", "n", "t"):
                    raise UnsupportedTokenizer(f"split pattern: escape \\{rest[:1]} at {i}")
                out.append(pattern[i:i + 2])
                i += 2
                continue
            body = cls[{"p{L}": "L", "p{N}": "N"}.get(key, "s")]
            if in_class and key == "S":
                raise UnsupportedTokenizer(f"split pattern: \\S inside a class at {i}")
            out.append(body if in_class else f"[^{body}]" if key == "S" else f"[{body}]")
            i += 1 + len(key)
            continue
        if c == "[" and not in_class:
            in_class = True
            if pattern.startswith("^", i + 1):
                out.append("[^")
                i += 2
                continue
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    if in_class:
        raise UnsupportedTokenizer("split pattern: a class is not closed")
    return "".join(out)


@functools.lru_cache(maxsize=None)
def split_regex(pattern: str) -> "re.Pattern[str]":
    """`translate(pattern)` compiled (once a process)."""
    return re.compile(translate(pattern))


def split_isolated(regex: "re.Pattern[str]", text: str) -> List[str]:
    """`Split(pattern, "Isolated")`: every match and every gap between them, in order."""
    pieces, end = [], 0
    for m in regex.finditer(text):
        if m.start() > end:
            pieces.append(text[end:m.start()])
        pieces.append(m.group())
        end = m.end()
    if end < len(text):
        pieces.append(text[end:])
    return pieces


class BPETokenizer:
    """A byte-level BPE pipeline with the surface `utils.tokenizer.HFTokenizer`
    reads: `encode(text, add_special_tokens=False)`, `decode(ids)`,
    `convert_tokens_to_ids(name)`, `vocab_size` (the base vocabulary) and
    `len()` (with the added tokens). Build it with `read_tokenizer(dir)`."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], pattern: str, nfc: bool,
                 added: Sequence[Tuple[str, bool]], unk_token: Optional[str] = None, layout: str = ""):
        self.vocab = vocab
        self.vocab_size = len(vocab)
        self.nfc, self.layout = nfc, layout
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, (a, b) in enumerate(merges):
            if (a, b) in self._ranks:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r} is listed twice")
            if a not in vocab or b not in vocab or a + b not in vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r}: a part or the result is not in the vocabulary")
            self._ranks[(a, b)] = rank
        # added tokens: content -> id, as `tokenizers` assigns them
        self.added: Dict[str, int] = {}
        normalized: Dict[str, bool] = {}
        for content, norm in added:
            if not content:
                continue
            if content in self.added:
                if normalized[content] != norm:
                    raise UnsupportedTokenizer(f"added token {content!r} is defined twice, with other flags")
                continue
            tid = vocab.get(content)
            if tid is None:
                top = max(self.added.values(), default=None)
                tid = top + 1 if top is not None and (top >= len(vocab) or not vocab) else len(vocab)
            self.added[content] = tid
            normalized[content] = norm
        # matched on the raw text (normalized=False), or on the normalized segments (in normalized form)
        self._raw_ids = {c: i for c, i in self.added.items() if not normalized[c]}
        self._norm_ids = {(unicodedata.normalize("NFC", c) if nfc else c): i
                          for c, i in self.added.items() if normalized[c]}
        self._raw_re = self._alternation(list(self._raw_ids))
        self._norm_re = self._alternation(list(self._norm_ids))
        self._split = split_regex(pattern)
        self._unk_id = self.convert_tokens_to_ids(unk_token) if unk_token is not None else None
        # id -> bytes for decoding: a token whose every character is in the byte alphabet is those bytes,
        # any other (an added token with a space, say) its UTF-8 (the ByteLevel decoder's rule)
        self._bytes: Dict[int, bytes] = {}
        for tok, tid in list(vocab.items()) + list(self.added.items()):
            self._bytes[tid] = bytes(_CHAR_BYTE[c] for c in tok) if all(c in _CHAR_BYTE for c in tok) \
                else tok.encode("utf-8")
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _alternation(tokens: List[str]) -> Optional["re.Pattern[str]"]:
        # longest first, so that at one position the longest token matches (leftmost-longest)
        if not tokens:
            return None
        return re.compile("|".join(re.escape(t) for t in sorted(tokens, key=len, reverse=True)))

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self.added))

    def __repr__(self) -> str:
        return (f"BPETokenizer(layout={self.layout!r}, vocab={self.vocab_size}, merges={len(self._ranks)}, "
                f"added={len(self.added)}, nfc={self.nfc})")

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        """A token -> its id (the unknown token's id, or None, for a token
        not in the vocabulary)."""
        tid = self.added.get(token, self.vocab.get(token))
        return self._unk_id if tid is None else tid

    @staticmethod
    def _split_added(text: str, regex, ids: Dict[str, int]):
        """(segment, None) for text between added tokens, (token, id) for each added token."""
        if regex is None:
            if text:
                yield text, None
            return
        end = 0
        for m in regex.finditer(text):
            if m.start() > end:
                yield text[end:m.start()], None
            yield m.group(), ids[m.group()]
            end = m.end()
        if end < len(text):
            yield text[end:], None

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Text -> ids. The accepted post-processors add no token, so
        `add_special_tokens` changes nothing (as in transformers)."""
        ids: List[int] = []
        for segment, tid in self._split_added(text, self._raw_re, self._raw_ids):
            if tid is not None:
                ids.append(tid)
                continue
            if self.nfc:
                segment = unicodedata.normalize("NFC", segment)
            for part, nid in self._split_added(segment, self._norm_re, self._norm_ids):
                if nid is not None:
                    ids.append(nid)
                    continue
                for piece in split_isolated(self._split, part):
                    ids.extend(self._word_ids(piece.encode("utf-8").decode("latin-1").translate(_BYTE_CHAR)))
        return ids

    def _word_ids(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = [self.vocab[s] for s in self._merge(word)]
            if len(self._cache) >= _CACHE_WORDS:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _merge(self, word: str) -> List[str]:
        """BPE as `tokenizers` runs it: symbols not in the vocabulary are
        dropped (no unknown token), then the adjacent pair of the lowest
        rank is merged, the leftmost first among equal ranks, until no pair
        has a rank."""
        syms: List[Optional[str]] = [c for c in word if c in self.vocab]
        n = len(syms)
        if n < 2:
            return syms
        ranks = self._ranks
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        heap = [(r, i) for i in range(n - 1) if (r := ranks.get((syms[i], syms[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            r, i = heapq.heappop(heap)
            j = nxt[i]
            if syms[i] is None or j < 0 or ranks.get((syms[i], syms[j])) != r:
                continue  # a pair that a merge before it changed
            syms[i] += syms[j]
            syms[j] = None
            k = nxt[i] = nxt[j]
            if k >= 0:
                prv[k] = i
            p = prv[i]
            if p >= 0 and (rp := ranks.get((syms[p], syms[i]))) is not None:
                heapq.heappush(heap, (rp, p))
            if k >= 0 and (rk := ranks.get((syms[i], syms[k]))) is not None:
                heapq.heappush(heap, (rk, i))
        return [s for s in syms if s is not None]

    def decode(self, ids) -> str:
        """Ids -> text: byte level, added tokens as their text, invalid UTF-8
        replaced, unknown ids dropped (transformers' `decode` at its defaults;
        a config that asks for `clean_up_tokenization_spaces` is refused)."""
        parts = (self._bytes.get(int(i)) for i in ids)
        return b"".join(p for p in parts if p is not None).decode("utf-8", errors="replace")


# -- reading the assets ------------------------------------------------------------------------------

def _read_json(path: str, kind: type):
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:  # JSONDecodeError and UnicodeDecodeError are ValueErrors
        raise UnsupportedTokenizer(f"{os.path.basename(path)}: {e}") from None
    if not isinstance(data, kind):
        raise UnsupportedTokenizer(f"{os.path.basename(path)}: not a JSON {kind.__name__}")
    return data


def _check_vocab(vocab, where: str) -> Dict[str, int]:
    if not isinstance(vocab, dict) or not all(isinstance(k, str) and type(v) is int and v >= 0
                                              for k, v in vocab.items()):
        raise UnsupportedTokenizer(f"{where}: the vocabulary is not a map of tokens to ids")
    if len(set(vocab.values())) != len(vocab):
        raise UnsupportedTokenizer(f"{where}: two tokens of the vocabulary share an id")
    return vocab


def _flag(entry: dict, key: str, want: bool, what: str) -> bool:
    value = entry.get(key, want)
    if not isinstance(value, bool):
        raise UnsupportedTokenizer(f"{what}: {key} is not a boolean")
    return value


def _added_entry(entry, what: str) -> Tuple[str, bool]:
    """An added token's JSON -> (content, normalized); refuses lstrip, rstrip
    and single_word. `normalized` defaults to not `special`, as in `tokenizers`."""
    if not isinstance(entry, dict) or not isinstance(entry.get("content"), str):
        raise UnsupportedTokenizer(f"{what}: an added token without content")
    for key in ("lstrip", "rstrip", "single_word"):
        if _flag(entry, key, False, what):
            raise UnsupportedTokenizer(f"{what}: added token {entry['content']!r} sets {key}")
    return entry["content"], _flag(entry, "normalized", not _flag(entry, "special", False, what), what)


def _special_strings(config: dict, cls: Optional[str]) -> List[str]:
    """The special tokens the tokenizer's config (and, unless `cls` is None,
    its class where the config is silent) names, in transformers' order
    (bos, eos, unk, sep, pad, cls, mask, additional)."""
    out: List[str] = []
    defaults = _CLASS_SPECIALS[cls] if cls else {}
    for key in _SPECIAL_KEYS:
        value = config[key] if key in config else defaults.get(key)
        out.append(value)
    out += list(config.get("additional_special_tokens") or [])
    names = []
    for value in out:
        if isinstance(value, dict):
            value = value.get("content")
        if value is None:
            continue
        if not isinstance(value, str):
            raise UnsupportedTokenizer("tokenizer_config.json: a special token is neither text nor null")
        if value not in names:
            names.append(value)
    return names


def _normalizer(spec) -> bool:
    """tokenizer.json's normalizer -> whether it is NFC (None: no normalizer)."""
    if spec is None:
        return False
    if isinstance(spec, dict) and spec.get("type") == "NFC":
        return True
    if isinstance(spec, dict) and spec.get("type") == "Sequence" and isinstance(spec.get("normalizers"), list):
        kinds = [n.get("type") if isinstance(n, dict) else None for n in spec["normalizers"]]
        if all(k == "NFC" for k in kinds):
            return bool(kinds)
    raise UnsupportedTokenizer(f"tokenizer.json: normalizer {json.dumps(spec)[:120]} (only none or NFC)")


def _byte_level(spec, use_regex: bool) -> bool:
    return (isinstance(spec, dict) and spec.get("type") == "ByteLevel"
            and spec.get("add_prefix_space", False) is False and spec.get("use_regex", True) is use_regex)


def _pre_tokenizer(spec) -> str:
    """tokenizer.json's pre-tokenizer -> its split pattern: `ByteLevel`
    (GPT-2's), or `Sequence[Split(pattern, Isolated), ByteLevel(use_regex=False)]`
    with GPT-2's or Qwen2's pattern."""
    if _byte_level(spec, True):
        return GPT2_PATTERN
    if isinstance(spec, dict) and spec.get("type") == "Sequence":
        seq = spec.get("pretokenizers")
        if isinstance(seq, list) and len(seq) == 2 and _byte_level(seq[1], False):
            split = seq[0]
            pattern = split.get("pattern") if isinstance(split, dict) else None
            regex = pattern.get("Regex") if isinstance(pattern, dict) else None
            if (split.get("type") == "Split" and split.get("behavior") == "Isolated"
                    and split.get("invert", False) is False and regex in (QWEN2_PATTERN, GPT2_PATTERN)):
                return regex
    raise UnsupportedTokenizer(f"tokenizer.json: pre-tokenizer {json.dumps(spec)[:160]} (only byte level, alone "
                               "or after the GPT-2 or Qwen2 split)")


def _merge_pairs(merges, where: str) -> List[Tuple[str, str]]:
    if not isinstance(merges, list):
        raise UnsupportedTokenizer(f"{where}: merges is not a list")
    out = []
    for m in merges:
        parts = m.split(" ") if isinstance(m, str) else m
        if not isinstance(parts, list) or len(parts) != 2 or not all(isinstance(p, str) and p for p in parts):
            raise UnsupportedTokenizer(f"{where}: merge {m!r} is not a pair")
        out.append((parts[0], parts[1]))
    return out


def _layout_a(path: str):
    """tokenizer.json -> (vocab, merges, pattern, nfc, added tokens of the file)."""
    tj = _read_json(os.path.join(path, "tokenizer.json"), dict)
    model = tj.get("model")
    if not isinstance(model, dict) or model.get("type") != "BPE":
        kind = model.get("type") if isinstance(model, dict) else model
        raise UnsupportedTokenizer(f"tokenizer.json: model type {kind!r} (only BPE)")
    for key, ok in (("dropout", (None,)), ("unk_token", (None,)), ("byte_fallback", (False, None)),
                    ("ignore_merges", (False, None)), ("continuing_subword_prefix", (None, "")),
                    ("end_of_word_suffix", (None, ""))):
        if model.get(key) not in ok:
            raise UnsupportedTokenizer(f"tokenizer.json: BPE sets {key} = {model.get(key)!r}")
    dec = tj.get("decoder")
    if not (isinstance(dec, dict) and dec.get("type") == "ByteLevel"):
        raise UnsupportedTokenizer(f"tokenizer.json: decoder {json.dumps(dec)[:120]} (only ByteLevel)")
    post = tj.get("post_processor")
    if post is not None and not (isinstance(post, dict) and post.get("type") == "ByteLevel"):
        raise UnsupportedTokenizer(f"tokenizer.json: post-processor {json.dumps(post)[:120]} (only none or "
                                   "ByteLevel)")
    vocab = _check_vocab(model.get("vocab"), "tokenizer.json")
    merges = _merge_pairs(model.get("merges"), "tokenizer.json")
    added_list = tj.get("added_tokens") or []
    if not isinstance(added_list, list):
        raise UnsupportedTokenizer("tokenizer.json: added_tokens is not a list")
    added = [_added_entry(e, "tokenizer.json") for e in added_list]
    return vocab, merges, _pre_tokenizer(tj.get("pre_tokenizer")), _normalizer(tj.get("normalizer")), added


def _layout_b(path: str, cls: str):
    """vocab.json + merges.txt -> (vocab, merges, Qwen2's pattern, NFC, no added tokens)."""
    if cls not in QWEN2_CLASSES:
        raise UnsupportedTokenizer(f"vocab.json + merges.txt with tokenizer_class {cls!r} (only Qwen2Tokenizer)")
    vocab = _check_vocab(_read_json(os.path.join(path, "vocab.json"), dict), "vocab.json")
    try:
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
    except (OSError, ValueError) as e:
        raise UnsupportedTokenizer(f"merges.txt: {e}") from None
    merges = []
    for n, line in enumerate(lines):  # as Qwen2Tokenizer reads it
        line = line.strip()
        if not line or (n == 0 and line.startswith("#version:")):
            continue
        parts = line.split()
        if len(parts) != 2:
            raise UnsupportedTokenizer(f"merges.txt line {n + 1}: not a pair")
        merges.append((parts[0], parts[1]))
    return vocab, merges, QWEN2_PATTERN, True, []


def read_tokenizer(path) -> BPETokenizer:
    """The tokenizer in directory `path` (layout (a) where tokenizer.json
    exists, else (b)) -> a BPETokenizer; raises UnsupportedTokenizer."""
    path = os.fspath(path)
    cfg_path = os.path.join(path, "tokenizer_config.json")
    if not os.path.isfile(cfg_path):
        raise UnsupportedTokenizer("no tokenizer_config.json (the class of the tokenizer is unknown)")
    config = _read_json(cfg_path, dict)
    cls = config.get("tokenizer_class")
    if cls not in _CLASS_SPECIALS:
        raise UnsupportedTokenizer(f"tokenizer_class {cls!r} (only PreTrainedTokenizerFast or Qwen2Tokenizer)")
    for key in ("add_prefix_space", "split_special_tokens", "clean_up_tokenization_spaces"):
        if config.get(key):
            raise UnsupportedTokenizer(f"tokenizer_config.json sets {key}")
    if os.path.isfile(os.path.join(path, "tokenizer.json")):
        layout, (vocab, merges, pattern, nfc, added) = "tokenizer.json", _layout_a(path)
    elif all(os.path.isfile(os.path.join(path, f)) for f in ("vocab.json", "merges.txt")):
        layout, (vocab, merges, pattern, nfc, added) = "vocab.json+merges.txt", _layout_b(path, cls)
    else:
        raise UnsupportedTokenizer("neither tokenizer.json nor vocab.json + merges.txt")
    specials = _special_strings(config, cls)
    decoder = config.get("added_tokens_decoder")
    if decoder is not None:
        if not isinstance(decoder, dict):
            raise UnsupportedTokenizer("tokenizer_config.json: added_tokens_decoder is not a map")
        try:
            order = sorted(decoder, key=int)
        except ValueError:
            raise UnsupportedTokenizer("tokenizer_config.json: an added_tokens_decoder key is not an id") from None
        added += [_added_entry(decoder[k], "tokenizer_config.json") for k in order]
    elif os.path.isfile(os.path.join(path, "added_tokens.json")):
        if os.path.isfile(os.path.join(path, "special_tokens_map.json")):
            raise UnsupportedTokenizer("added_tokens.json with special_tokens_map.json and no added_tokens_decoder")
        table = _read_json(os.path.join(path, "added_tokens.json"), dict)
        if not all(isinstance(k, str) and type(v) is int for k, v in table.items()):
            raise UnsupportedTokenizer("added_tokens.json: not a map of tokens to ids")
        named = _special_strings(config, None)  # transformers' legacy read: special if the config names it
        added += [(k, k not in named) for k, _ in sorted(table.items(), key=lambda kv: kv[1])]
    added += [(s, False) for s in specials]
    unk = config["unk_token"] if "unk_token" in config else _CLASS_SPECIALS[cls].get("unk_token")
    if isinstance(unk, dict):
        unk = unk.get("content")
    return BPETokenizer(vocab, merges, pattern, nfc, added, unk_token=unk, layout=layout)
