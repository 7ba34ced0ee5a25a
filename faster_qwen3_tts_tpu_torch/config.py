"""Model configurations of the PyTorch port.

The port's own copy of faster_qwen3_tts_tpu/config.py: the same dataclasses,
field names and field order, speaker tables, presets and `config_from_dict`,
so a config of either package converts to the other through
`config_from_dict(dataclasses.asdict(cfg))` and duck-types where only fields
are read. The port imports nothing of the JAX package.

Mirrors the config contract the reference consumes from upstream `qwen_tts`
(SURVEY §2.4: `model.model.config.talker_config` fields at reference
model.py:619-680, generate.py:41-44, predictor_graph.py:44-58), as plain
frozen dataclasses, hashable so they can key caches.

Size presets follow the published Qwen3 dense backbone shapes (0.6B / 1.7B,
28 layers, GQA 16/8 heads, head_dim 128) and the public Code2Wav codec shape
(12.5 Hz frames -> 24 kHz, 1920x upsampling, 16 RVQ codebooks of 2048 entries).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """28-layer Qwen3-style dense decoder that emits codebook-0 tokens.

    Reference contract: talker_graph.py:27-59 (hidden_size, num_hidden_layers),
    generate.py:41-44 (codec_eos_token_id, num_code_groups, vocab_size).
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # Codec token vocabulary: 2048 acoustic ids + 1024 special/control ids.
    # The generation loop suppresses the top-1024 ids except EOS
    # (reference generate.py:46-50).
    vocab_size: int = 3072
    # Text side (embeddings come from the text tokenizer vocabulary and are
    # projected into the talker width by `text_projection`).
    text_vocab_size: int = 151_936
    text_hidden_size: int = 2048
    attention_bias: bool = False
    sliding_window: Optional[int] = None
    # Per-layer attention kinds ("full_attention" | "sliding_attention"),
    # mirroring the upstream config's `layer_types` (reference
    # predictor_graph.py:58 reads it; model.py:619-680 lists the field).
    # None + sliding_window set => every layer sliding (HF derivation).
    layer_types: Optional[Tuple[str, ...]] = None
    max_position_embeddings: int = 32768

    # --- special codec ids (top-1024 control band) ---
    codec_eos_token_id: int = 2150
    codec_pad_id: int = 2148
    codec_bos_id: int = 2149
    codec_think_id: int = 2154
    codec_nothink_id: int = 2155
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157
    # language name (lower) -> codec id
    codec_language_id: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: _freeze(
            {
                "chinese": 2158,
                "english": 2159,
                "german": 2160,
                "italian": 2161,
                "portuguese": 2162,
                "spanish": 2163,
                "japanese": 2164,
                "korean": 2165,
                "french": 2166,
                "russian": 2167,
                "cantonese": 2168,
                "beijing_dialect": 2169,
                "sichuan_dialect": 2170,
                "shanghai_dialect": 2171,
            }
        )
    )
    # speaker name (lower) -> codec id (CustomVoice checkpoints only)
    spk_id: Mapping[str, int] = dataclasses.field(default_factory=lambda: _freeze({}))
    # speaker name (lower) -> dialect-language key or False
    spk_is_dialect: Mapping[str, object] = dataclasses.field(default_factory=lambda: _freeze({}))
    num_code_groups: int = 16

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """5-layer MTP code predictor that emits codebooks 1..15 per frame.

    Reference contract: predictor_graph.py:34-76 (num_code_groups, max_seq=17,
    small_to_mtp_projection, per-codebook lm_head / codec_embedding).
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    vocab_size: int = 2048  # acoustic codebook entries per group
    num_code_groups: int = 16
    attention_bias: bool = False
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None

    @property
    def num_codebooks(self) -> int:  # 15
        return self.num_code_groups - 1

    @property
    def max_seq(self) -> int:  # 17 = 2-token prefill + 15 steps
        return 2 + self.num_codebooks

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Code2Wav RVQ codec decoder: [T,16] codes -> 24 kHz waveform.

    Structure follows the public Code2Wav architecture (pre-transformer with
    sliding-window attention, 2x2 ConvNeXt upsample stages, 4 transposed-conv
    decoder blocks with snake-beta activations). Total upsample factor
    2*2*8*5*4*3 = 1920 samples/frame -> 24000/1920 = 12.5 frames/s.
    Reference call surface: `speech_tokenizer.decode({"audio_codes": [1,T,16]})`
    (reference model.py:918-924) and the 25-frame left-context chunked decode
    (reference model.py:1048-1056).
    """

    codebook_size: int = 2048
    num_quantizers: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 64
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 72
    layer_scale_initial_scale: float = 0.01
    attention_bias: bool = False
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    decoder_dim: int = 1536
    sample_rate: int = 24000

    @property
    def total_upsample(self) -> int:
        n = 1
        for r in self.upsampling_ratios:
            n *= r
        for r in self.upsample_rates:
            n *= r
        return n

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.total_upsample


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Reference-audio -> 2048-d x-vector speaker embedding (ECAPA-TDNN).

    The reference consumes this via `create_voice_clone_prompt(...)` whose
    prompt items carry a 2048-d bf16 `ref_spk_embedding`
    (reference README.md:500, model.py:429-451). The architecture is the
    PUBLIC Qwen ECAPA module (transformers qwen2_5_omni
    `ECAPA_TimeDelayNet`, numerically matched in
    tests/test_encoder_torch_parity.py): reflect-padded TDNN stem,
    SE-Res2Net blocks (dilations 2/3/4), multi-layer feature aggregation
    (requires mfa_dim == num_blocks * channels — the MFA input is the
    concat of the block outputs), channel-wise attentive statistics
    pooling, k=1-conv fc to embedding_dim, no norms anywhere.
    """

    mel_bins: int = 80
    sample_rate: int = 16000
    channels: int = 512
    embedding_dim: int = 2048
    num_blocks: int = 3           # SE-Res2Net blocks; dilations 2,3,4,...
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    mfa_dim: int = 1536


@dataclasses.dataclass(frozen=True)
class Qwen3TTSConfig:
    """Top-level config bundling all submodels plus the text special ids.

    Mirrors `model.model.config` fields consumed by the reference
    (model.py:619-680): tts_bos/eos/pad token ids + talker_config.
    """

    model_type: str = "base"  # base | custom_voice | voice_design
    model_size: str = "0b6"  # 0b6 | 1b7
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671
    talker: TalkerConfig = dataclasses.field(default_factory=TalkerConfig)
    predictor: PredictorConfig = dataclasses.field(default_factory=PredictorConfig)
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    speaker_encoder: SpeakerEncoderConfig = dataclasses.field(default_factory=SpeakerEncoderConfig)

    @property
    def sample_rate(self) -> int:
        return self.codec.sample_rate

    @property
    def frame_rate(self) -> float:
        return self.codec.frame_rate


class _FrozenMap(dict):
    """Hashable immutable mapping, so configs stay hashable."""

    def __hash__(self):  # type: ignore[override]
        return hash(tuple(sorted(self.items())))

    def _blocked(self, *a, **k):
        raise TypeError("config mappings are immutable")

    __setitem__ = _blocked
    __delitem__ = _blocked
    update = _blocked
    pop = _blocked
    popitem = _blocked
    clear = _blocked
    setdefault = _blocked


def _freeze(d: dict) -> _FrozenMap:
    return _FrozenMap(d)


_CUSTOM_VOICE_SPEAKERS = {
    # CustomVoice preset speakers -> codec control ids (band above language ids).
    "aiden": 2180,
    "serena": 2181,
    "dylan": 2182,
    "eric": 2183,
    "ono": 2184,
    "sohee": 2185,
    "uma": 2186,
    "vivian": 2187,
    "ryan": 2188,
}
_CUSTOM_VOICE_DIALECT = {
    "aiden": False,
    "serena": False,
    "dylan": "beijing_dialect",
    "eric": "sichuan_dialect",
    "ono": False,
    "sohee": False,
    "uma": False,
    "vivian": False,
    "ryan": False,
}


def _talker(size: str, **over) -> TalkerConfig:
    if size == "0b6":
        base = dict(hidden_size=1024, intermediate_size=3072, text_hidden_size=1024)
    elif size == "1b7":
        base = dict(hidden_size=2048, intermediate_size=6144, text_hidden_size=2048)
    else:
        raise ValueError(f"unknown size {size!r}")
    base.update(over)
    return TalkerConfig(**base)


def get_config(name: str) -> Qwen3TTSConfig:
    """Resolve a model name / HF id to a config preset.

    Accepts the five reference-served model ids (demo/server.py:64-70) or the
    short forms '0.6b', '1.7b', '1.7b-custom', '1.7b-design', plus a local
    directory containing config.json.
    """
    if os.path.isdir(name):
        cfg_path = os.path.join(name, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                return config_from_dict(json.load(f))

    key = name.lower()
    size = "1b7" if "1.7b" in key else "0b6"
    if "customvoice" in key or key.endswith("-custom") or "custom_voice" in key:
        mtype = "custom_voice"
    elif "voicedesign" in key or key.endswith("-design") or "voice_design" in key:
        mtype = "voice_design"
    else:
        mtype = "base"

    talker_over = {}
    if mtype == "custom_voice":
        talker_over = dict(
            spk_id=_freeze(_CUSTOM_VOICE_SPEAKERS),
            spk_is_dialect=_freeze(_CUSTOM_VOICE_DIALECT),
        )
    talker = _talker(size, **talker_over)
    pred = PredictorConfig()
    return Qwen3TTSConfig(model_type=mtype, model_size=size, talker=talker, predictor=pred)


def tiny_test_config(model_type: str = "base") -> Qwen3TTSConfig:
    """A miniature full-stack config: real structure (layer kinds, special
    ids, codec frame geometry — still 1920 samples/frame at 24 kHz), tiny
    widths. Used by harness smoke modes (bench.py FQ3T_BENCH_TINY,
    benchmarks/cold_start.py --tiny) so the measurement plumbing itself can
    be exercised on CPU in seconds."""
    cfg = get_config("0.6b")
    return dataclasses.replace(
        cfg,
        model_type=model_type,
        talker=dataclasses.replace(
            cfg.talker, num_hidden_layers=2, hidden_size=128,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32,
            intermediate_size=256, text_hidden_size=64, text_vocab_size=512,
        ),
        predictor=dataclasses.replace(
            cfg.predictor, num_hidden_layers=2, hidden_size=64,
            num_attention_heads=2, num_key_value_heads=1, head_dim=32,
            intermediate_size=128,
        ),
        codec=dataclasses.replace(
            cfg.codec, hidden_size=64, num_hidden_layers=1,
            intermediate_size=128, num_attention_heads=2,
            num_key_value_heads=2, head_dim=32,
        ),
    )


def config_from_dict(d: dict) -> Qwen3TTSConfig:
    """Build a config from a (nested) plain dict, e.g. parsed config.json."""

    def build(cls, sub):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in sub.items():
            if k not in fields:
                continue
            if isinstance(v, dict) and not dataclasses.is_dataclass(fields[k].type):
                v = _freeze(v)
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    talker = build(TalkerConfig, d.get("talker_config", d.get("talker", {})))
    pred = build(PredictorConfig, d.get("predictor_config", d.get("predictor", {})))
    codec = build(CodecConfig, d.get("codec_config", d.get("codec", {})))
    spk = build(SpeakerEncoderConfig, d.get("speaker_encoder_config", d.get("speaker_encoder", {})))
    top = {
        k: d[k]
        for k in ("model_type", "model_size", "tts_bos_token_id", "tts_eos_token_id", "tts_pad_token_id")
        if k in d
    }
    return Qwen3TTSConfig(talker=talker, predictor=pred, codec=codec, speaker_encoder=spk, **top)
