"""Generate speech from a precomputed x-vector on the PyTorch port (no
reference audio at request time: the fastest voice-clone path).

    python examples_torch/generate_with_embedding.py speaker.npy "Hello" -o out.wav [--device cuda]

A `.spk` file (raw float32, `extract_speaker.py --spk` or the native
backend's cache) goes through `NativeQwen3TTS(ref_spk=...)` instead.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from faster_qwen3_tts_tpu_torch import FasterQwen3TTS  # noqa: E402
from faster_qwen3_tts_tpu_torch.utils import native  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("speaker_file", help="a .npy x-vector, or a raw float32 .spk file")
    ap.add_argument("text")
    ap.add_argument("-o", "--output", default="output.wav")
    ap.add_argument("--model", default="Qwen/Qwen3-TTS-12Hz-0.6B-Base")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--language", default="English")
    ap.add_argument("--quant", default="BF16")
    ap.add_argument("--max-new-tokens", type=int, default=2048)
    args = ap.parse_args(argv)

    gen = dict(max_new_tokens=args.max_new_tokens)
    t_load = time.perf_counter()
    if args.speaker_file.endswith(".spk"):
        model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, quant=args.quant, backend="native")
        load_s = time.perf_counter() - t_load
        t0 = time.perf_counter()
        audio, sr = model.generate_voice_clone(args.text, args.language, ref_spk=args.speaker_file,
                                               xvec_only=True, **gen)
    else:
        prompt = {"ref_spk_embedding": [np.load(args.speaker_file)], "x_vector_only_mode": [True],
                  "icl_mode": [False], "ref_code": [None]}
        model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, quant=args.quant)
        load_s = time.perf_counter() - t_load
        t0 = time.perf_counter()
        audio, sr = model.generate_voice_clone(args.text, args.language, voice_clone_prompt=prompt, **gen)
    wall = time.perf_counter() - t0
    native.write_wav(args.output, audio[0], sr)
    print(f"wrote {args.output}: {len(audio[0]) / sr:.2f}s in {wall:.2f}s (RTF {(len(audio[0]) / sr) / wall:.2f}; "
          f"model loaded in {load_s:.1f}s)")


if __name__ == "__main__":
    main()
