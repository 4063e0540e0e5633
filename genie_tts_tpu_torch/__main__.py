"""Command-line interface of the port::

    python -m genie_tts_tpu_torch tts --model DIR --lang ja --ref ref.wav \
        --ref-text "こんにちは" --text "こんにちは。" --out out.wav [--device cpu]

``--device`` defaults to cuda; without a GPU the run stops unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = argparse.ArgumentParser(prog="genie_tts_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tts", help="synthesize text to a wav file")
    p.add_argument("--model", required=True, help="character checkpoint dir")
    p.add_argument("--lang", default="ja")
    p.add_argument("--ref", required=True, help="reference audio path")
    p.add_argument("--ref-text", required=True, help="reference transcript")
    p.add_argument("--text", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--no-split", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.add_argument("--dtype", default=None,
                   help="compute dtype: bfloat16 (default) or float32")

    args = parser.parse_args(argv)

    import genie_tts_tpu_torch as genie

    if args.cmd == "tts":
        genie.load_character("cli", args.model, args.lang, device=args.device,
                             dtype=args.dtype)
        genie.set_reference_audio("cli", args.ref, args.ref_text, args.lang)
        genie.tts("cli", args.text, split_sentence=not args.no_split,
                  save_path=args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
