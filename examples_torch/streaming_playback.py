"""Stream TTS to the speakers (or a wav file when headless) on the PyTorch
port.

    python examples_torch/streaming_playback.py "Hello there" --ref-audio ref.wav \\
        --ref-text "..." [--xvec-only] [--out out.wav] [--device cuda] [--ref-cache-dir DIR]

The voice goes through the native backend's reference cache: the first run
extracts it, later runs with the same recording read it from
`--ref-cache-dir`.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from audio import HAS_AUDIO, StreamPlayer  # noqa: E402

from faster_qwen3_tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from faster_qwen3_tts_tpu_torch.utils import native  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("text")
    ap.add_argument("--model", default="Qwen/Qwen3-TTS-12Hz-0.6B-Base")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ref-audio", required=True)
    ap.add_argument("--ref-text", default="")
    ap.add_argument("--xvec-only", action="store_true")
    ap.add_argument("--ref-cache-dir", default=None, help="voice-reference cache dir")
    ap.add_argument("--language", default="English")
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--quant", default="BF16")
    ap.add_argument("--max-new-tokens", type=int, default=2048)
    ap.add_argument("--out", default="streamed.wav")
    args = ap.parse_args(argv)

    model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, quant=args.quant, backend="native",
                                           voice_ref_cache_dir=args.ref_cache_dir)
    _, _, prof = model.extract_voice_ref(args.ref_audio, xvec_only=args.xvec_only)
    print(f"voice reference: cache {prof['cache']} ({prof['prepare_ms']:.0f} ms)")
    player = StreamPlayer(sample_rate=model.sample_rate)
    player.start()

    t0 = time.perf_counter()
    ttfa = None
    for audio, sr, timing in model.generate_voice_clone_streaming(
        args.text,
        args.language,
        ref_audio=args.ref_audio,
        ref_text=args.ref_text,
        xvec_only=args.xvec_only,
        chunk_size=args.chunk_size,
        max_new_tokens=args.max_new_tokens,
    ):
        if ttfa is None:
            ttfa = (time.perf_counter() - t0) * 1000
            print(f"TTFA {ttfa:.0f} ms")
        player.push(audio)
    player.drain()
    if not HAS_AUDIO:
        wav = player.collected()
        native.write_wav(args.out, wav, model.sample_rate)
        print(f"(headless) wrote {args.out}: {len(wav) / model.sample_rate:.2f}s")


if __name__ == "__main__":
    main()
