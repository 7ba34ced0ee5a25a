"""Extract a reusable x-vector speaker embedding from reference audio, on
the PyTorch port.

The voice is extracted once and saved as float32 (`.npy`, or with `--spk`
the raw `.spk` file that `NativeQwen3TTS(ref_spk=...)` reads);
`generate_with_embedding.py` then speaks with it without touching the
speaker encoder.

    python examples_torch/extract_speaker.py ref.wav speaker.npy [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from faster_qwen3_tts_tpu_torch import FasterQwen3TTS  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_audio")
    ap.add_argument("out", nargs="?", default="speaker.npy")
    ap.add_argument("--model", default="Qwen/Qwen3-TTS-12Hz-0.6B-Base")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--spk", action="store_true", help="write the raw float32 .spk format instead of .npy")
    args = ap.parse_args(argv)

    model = FasterQwen3TTS.from_pretrained(args.model, device=args.device)
    items = model.create_voice_clone_prompt(args.ref_audio, x_vector_only_mode=True)
    xvec = np.asarray(items[0].ref_spk_embedding, np.float32)
    if args.spk:
        xvec.tofile(args.out)
    else:
        np.save(args.out, xvec)
    print(f"wrote {args.out}: {xvec.shape[0]}-d x-vector ({xvec.nbytes} bytes)")


if __name__ == "__main__":
    main()
