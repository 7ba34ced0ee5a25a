"""faster_qwen3_tts_tpu_torch: the PyTorch / CUDA port of faster_qwen3_tts_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports torch and never jax; the JAX package's jax-free modules
(`config`, `utils.tokenizer`, `utils.audio`) are reused as they are.
"""

__all__ = ["FasterQwen3TTS"]


def __getattr__(name):
    if name == "FasterQwen3TTS":
        from .model import FasterQwen3TTS

        return FasterQwen3TTS
    raise AttributeError(name)
