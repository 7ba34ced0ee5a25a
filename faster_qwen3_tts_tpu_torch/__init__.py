"""faster_qwen3_tts_tpu_torch: the PyTorch / CUDA port of faster_qwen3_tts_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports torch and never jax, and nothing of the JAX package: it keeps
its own copies of what it needs (`config`, `utils.tokenizer`, `utils.audio`,
`csrc/fq3t.cpp`). Entry points: `FasterQwen3TTS.from_pretrained` (and
`NativeQwen3TTS`, the same engine with the voice-reference disk cache), the
command line (`python -m faster_qwen3_tts_tpu_torch.cli`) and the
OpenAI-compatible server (`python -m faster_qwen3_tts_tpu_torch.server`).
The package exports the JAX package's top-level names; importing it loads
no torch (the model classes load lazily).
"""

from .config import (
    CodecConfig,
    PredictorConfig,
    Qwen3TTSConfig,
    SpeakerEncoderConfig,
    TalkerConfig,
    get_config,
)

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "PredictorConfig",
    "Qwen3TTSConfig",
    "SpeakerEncoderConfig",
    "TalkerConfig",
    "get_config",
    "FasterQwen3TTS",
    "NativeQwen3TTS",
    "__version__",
]


def __getattr__(name):
    if name == "FasterQwen3TTS":
        from .model import FasterQwen3TTS

        return FasterQwen3TTS
    if name == "NativeQwen3TTS":
        from .native_backend import NativeQwen3TTS

        return NativeQwen3TTS
    raise AttributeError(name)
