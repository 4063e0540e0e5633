"""Command-line interface of the port::

    python -m genie_tts_tpu_torch tts --model DIR --lang ja --ref ref.wav \
        --ref-text "こんにちは" --text "こんにちは。" --out out.wav [--device cpu]
    python -m genie_tts_tpu_torch convert --ckpt model.ckpt --pth model.pth --out DIR \
        [--version v2|v2ProPlus]
    python -m genie_tts_tpu_torch serve --host 127.0.0.1 --port 8000 [--device cpu]

``--device`` defaults to cuda; without a GPU the run stops unless
``--device cpu`` is given. A V2ProPlus character reads its speaker
encoder from ``GENIE_SV_MODEL`` (default
``GENIE_DATA_DIR/speaker_encoder.safetensors``).
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

    p = sub.add_parser("convert", help="convert torch checkpoints")
    p.add_argument("--ckpt", required=True, help="T2S .ckpt path")
    p.add_argument("--pth", required=True, help="SoVITS .pth path")
    p.add_argument("--out", required=True, help="output character dir")
    p.add_argument("--lang", default="ja")
    p.add_argument("--version", choices=["v2", "v2ProPlus"], default=None,
                   help="model version (default: auto-detect from keys)")

    p = sub.add_parser("serve", help="start the HTTP server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="torch device for loaded characters (default cuda; "
                        "'cpu' to serve on the CPU)")
    p.add_argument("--warmup", metavar="MODEL_DIR", default=None,
                   help="character dir to load as 'warmup', sweep and unload "
                        "before accepting requests (engine.warmup(..., "
                        "sweep=True)): builds every kernel. Its captured graphs "
                        "read its weights and go with it; then every character "
                        "the server loads is swept at its first "
                        "/set_reference_audio (api.sweep_on_reference)")
    p.add_argument("--warmup-lang", default="ja")
    p.add_argument("--warmup-ref", default=None,
                   help="reference wav for the warmup (needs HuBERT; "
                        "default: random reference features)")
    p.add_argument("--warmup-ref-text", default="こんにちは")

    args = parser.parse_args(argv)

    import genie_tts_tpu_torch as genie

    if args.cmd == "tts":
        genie.load_character("cli", args.model, args.lang, device=args.device,
                             dtype=args.dtype)
        genie.set_reference_audio("cli", args.ref, args.ref_text, args.lang)
        genie.tts("cli", args.text, split_sentence=not args.no_split,
                  save_path=args.out)
        print(f"wrote {args.out}")
    elif args.cmd == "convert":
        from genie_tts_tpu_torch.convert.torch_convert import convert_character

        version = convert_character(args.ckpt, args.pth, args.out, language=args.lang,
                                    version=args.version)
        print(f"converted {version} -> {args.out}")
    elif args.cmd == "serve":
        from genie_tts_tpu_torch.config import resolve_device

        resolve_device(args.device)      # no GPU and no device named: stop here
        if args.warmup:
            _warmup(args)
        genie.start_server(host=args.host, port=args.port, device=args.device)
    return 0


def _warmup(args) -> None:
    """Load the ``--warmup`` character as ``warmup``, run the engine's
    warmup sweep on it and unload it, then set
    ``api.sweep_on_reference``. The graphs are its configuration's
    (``runtime/graphs.py``: they read a bank that each character binds),
    so they stay and serve every later character of that configuration
    warm, as the JAX package's ``serve --warmup`` compiles programs that
    serve every character; a character of another configuration (or a
    clip at another prompt bucket) is swept at its first
    ``/set_reference_audio``."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.runtime.engine import make_random_reference

    api.load_character("warmup", args.warmup, args.warmup_lang, device=args.device)
    char = api.model_manager.get("warmup")
    if args.warmup_ref:
        api.set_reference_audio("warmup", args.warmup_ref, args.warmup_ref_text,
                                args.warmup_lang)
        ref = api._reference_features(char, api._reference_audios["warmup"])
    else:
        ref = make_random_reference(char, api.engine)
    n = api.engine.warmup(char, ref, sweep=True)
    captured = sum(c.stats["captures"] for c in api.engine.graph_caches(char))
    del char
    api.unload_character("warmup")
    api.sweep_on_reference = True
    print(f"warmup: captured {captured} graphs ({n} units); they serve every character "
          f"of this configuration")


if __name__ == "__main__":
    sys.exit(main())
