"""TTS serving daemon: the micro-batching HTTP server over the Synthesizer
(port of serve.py; the endpoints are `serving.py`'s).

  POST /tts         {"texts": ["Hello there.", ...]} or {"text": "paragraph"}
                    → {"wavs": [<b64 int16 PCM>], "sample_rate": 22050, "rtf": ...}
  POST /tts_stream  {"text": "paragraph"} → NDJSON, one line per sentence
  GET  /healthz     → {"ok": true, "batch_sizes": [...], "device": ..., "card": ...}

    python -m dex_tts_tpu_torch.serve --config dex_tts_tpu/config/presets/vctk.yaml \\
        --weight_path checkpoints/VCTK-0 --ref_name ref.wav --port 8901

``--config`` reads a YAML config in the JAX package's layout; ``--preset``
names one of the port's presets instead. ``--device`` replaces serve.py's
``--platform`` (CUDA unless ``--device cpu``); ``--random_init`` serves
random weights when no checkpoint is found (a smoke run). serve.py's
``--compile_cache`` is not ported: it enabled XLA's persistent compile
cache, which has no counterpart here.
"""

from __future__ import annotations

import argparse
import signal
import threading

import torch

from dex_tts_tpu_torch.config import load_preset_or_config
from dex_tts_tpu_torch.eval.evaluation import load_synthesizer
from dex_tts_tpu_torch.serving import MicroBatcher, make_server
from dex_tts_tpu_torch.utils.device import card_line


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--config", default=None, metavar="YAML",
                        help="a YAML config in the JAX package's layout")
    source.add_argument("--preset", default=None, help="one of config.PRESETS")
    p.add_argument("--weight_path", required=True,
                   help="experiment dir (ckpt/<tag>.pth or model-*.pth) or a .pth file")
    p.add_argument("--ref_name", default=None,
                   help="default reference wav (DEX style source)")
    p.add_argument("--spk_id", type=int, default=None, help="GeDEX speaker")
    p.add_argument("--n_timesteps", type=int, default=50)
    p.add_argument("--dit_cache_interval", type=int, default=1,
                   help="approximate turbo sampling: reuse the DiT "
                        "mid-block for k-1 of every k steps (1 = exact)")
    p.add_argument("--solver", default="euler", choices=["euler", "heun", "dpmpp2m"],
                   help="ODE solver; dpmpp2m (DPM-Solver++ 2M, 2nd-order "
                        "multistep) reaches the 50-step euler solution "
                        "with ~16-25 steps")
    p.add_argument("--temperature", type=float, default=1.5)
    p.add_argument("--length_scale", type=float, default=1.0,
                   help="duration multiplier (speech-rate control)")
    p.add_argument("--checkpoint_tag", default="best-train")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--split_length_ratio", type=float, default=2.0,
                   help="split a collected batch at the largest text-"
                        "length gap when max/min exceeds this ratio "
                        "(padding waste control; 0 disables)")
    p.add_argument("--max_queue", type=int, default=None,
                   help="admission-queue bound: beyond this many pending "
                        "sentences new requests are fast-rejected with "
                        "503 + Retry-After (default 8*max_batch; 0 "
                        "disables backpressure)")
    p.add_argument("--warmup", default="Warm up the kernels before serving.",
                   help="sentence synthesized max_batch times at startup ('' skips)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--random_init", action="store_true",
                   help="random weights when no checkpoint is found (smoke runs only)")
    return p.parse_args(argv)


def build_server(args):
    """Load the synthesizer, warm it up on this thread, and wrap it in a
    MicroBatcher and the HTTP server (not yet serving) → (server,
    batcher). The batcher's one worker thread makes every `tts` call."""
    torch.manual_seed(args.seed)  # random-init weights only
    preset = load_preset_or_config(args.preset, args.config)
    synth = load_synthesizer(
        preset, args.weight_path, n_timesteps=args.n_timesteps, tag=args.checkpoint_tag,
        dit_cache_interval=args.dit_cache_interval, solver=args.solver,
        device=args.device, random_init=args.random_init,
    )
    # one generator on the device, seeded once and drawn by every batch in
    # turn (a tts call without one would seed a fresh generator with 0, and
    # every batch would get the same noise); only the worker thread uses it
    # once the batcher exists
    generator = torch.Generator(synth.device).manual_seed(args.seed)
    # fixed reference: prepared once at startup, not per request
    ref_feats = synth.prepare_reference(args.ref_name) if args.ref_name else None

    def infer(texts):
        kw = {}
        if ref_feats is not None:
            kw["ref_feats"] = [ref_feats] * len(texts)
        if args.spk_id is not None:
            kw["spk_ids"] = [args.spk_id] * len(texts)
        return synth.tts(texts, generator=generator, temperature=args.temperature,
                         length_scale=args.length_scale, **kw)

    if args.warmup:
        # on this thread, before the worker and any request thread exist:
        # the first call builds and loads the kernels
        # (ops.kernels.load_library), which then never happens under load
        print("warmup synthesis ...", flush=True)
        infer([args.warmup] * max(1, args.max_batch))

    batcher = MicroBatcher(
        infer, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        split_length_ratio=args.split_length_ratio, max_queue=args.max_queue,
    )
    srv = make_server(
        batcher, host=args.host, port=args.port, sample_rate=preset.sample_rate,
        info={"device": str(synth.device),
              "card": card_line() if synth.device.type == "cuda" else None,
              "n_timesteps": args.n_timesteps, "solver": args.solver},
    )
    return srv, batcher


def main(argv=None):
    args = parse_args(argv)
    srv, batcher = build_server(args)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port} (max_batch {args.max_batch}, "
          f"max_wait {args.max_wait_ms} ms)", flush=True)

    # SIGTERM (maintenance / rolling deploy) → stop accepting, finish the
    # in-flight batch, fail queued requests fast, exit 0. srv.shutdown()
    # blocks until serve_forever acknowledges, so it runs off the main
    # thread (the handler interrupts serve_forever).
    def _graceful(signum, frame):
        print("SIGTERM: shutting down after in-flight batch", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        srv.server_close()


if __name__ == "__main__":
    main()
