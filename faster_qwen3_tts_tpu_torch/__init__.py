"""faster_qwen3_tts_tpu_torch: the PyTorch / CUDA port of faster_qwen3_tts_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports torch and never jax, and nothing of the JAX package: it keeps
its own copies of what it needs (`config`, `utils.tokenizer`, `utils.audio`).
Entry points: `FasterQwen3TTS.from_pretrained`, the command line
(`python -m faster_qwen3_tts_tpu_torch.cli`) and the OpenAI-compatible
server (`python -m faster_qwen3_tts_tpu_torch.server`).
"""

__all__ = ["FasterQwen3TTS"]


def __getattr__(name):
    if name == "FasterQwen3TTS":
        from .model import FasterQwen3TTS

        return FasterQwen3TTS
    raise AttributeError(name)
