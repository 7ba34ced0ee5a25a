#!/usr/bin/env python3
"""What reading a checkpoint's tokenizer costs a fresh process: the port's
BPE reader against `transformers.AutoTokenizer`.

    python3 tools/tokenizer_load_cost.py [--rounds N] [--out FILE]

From the repository root. Each round starts one fresh interpreter per way,
in turn, on the Qwen2-layout fixture (tests/torch_fixtures/qwen2_tokenizer,
the layout Qwen checkpoints ship), as a restarted server process would:

- reader: `import torch` (already paid by any process of the port), then
  the port's `load_tokenizer(dir)`, its module import included;
- auto: `import torch`, then `from transformers import AutoTokenizer` and
  `AutoTokenizer.from_pretrained(dir)`.

Each prints the ms after `import torch` to a loaded tokenizer and whether
its ids of the fixed texts equal tests/torch_fixtures/tokenizer_expected.json.
Host time: it needs no card. Prints one JSON line per run, then a summary
line (the `transformers` version, or null where it does not import);
--out writes them all.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "torch_fixtures" / "qwen2_tokenizer"
EXPECTED = REPO / "tests" / "torch_fixtures" / "tokenizer_expected.json"

CHILD = {
    "reader": ("from faster_qwen3_tts_tpu_torch.utils.tokenizer import load_tokenizer\n"
               "tok = load_tokenizer(path)\n"
               "encode = tok.encode\n"),
    "auto": ("from transformers import AutoTokenizer\n"
             "tok = AutoTokenizer.from_pretrained(path)\n"
             "encode = lambda t: tok.encode(t, add_special_tokens=False)\n"),
}
PRELUDE = ("import json, sys, time\nimport torch\npath = sys.argv[1]\nt0 = time.perf_counter()\n")
CODA = ("ms = (time.perf_counter() - t0) * 1000.0\n"
        "want = json.load(open(sys.argv[2]))\n"
        "ids = want['fixtures']['qwen2_tokenizer']['ids']\n"
        "same = all(encode(t) == i for t, i in zip(want['texts'], ids))\n"
        "print(json.dumps({'ms': ms, 'class': type(getattr(tok, 'tok', tok)).__name__, 'ids_equal_committed': same}))\n")


def run(way: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", PRELUDE + CHILD[way] + CODA, str(FIXTURE), str(EXPECTED)],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    if proc.returncode != 0:
        return {"way": way, "error": proc.stderr.strip().splitlines()[-1][:300]}
    return {"way": way, **json.loads(proc.stdout.strip().splitlines()[-1])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    rows = []
    for r in range(args.rounds):
        for way in ("reader", "auto") if r % 2 == 0 else ("auto", "reader"):
            rows.append({"round": r, **run(way)})
            print(json.dumps(rows[-1]), flush=True)
    try:
        import transformers
        version = transformers.__version__
    except ImportError:
        version = None
    summary = {"transformers": version}
    for way in CHILD:
        ms = sorted(x["ms"] for x in rows if x["way"] == way and "ms" in x)
        summary[way] = {"ms": ms, "median_ms": ms[len(ms) // 2] if ms else None}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in rows + [summary]))


if __name__ == "__main__":
    main()
