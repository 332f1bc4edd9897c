"""Offline preprocessing CLI (port of preprocess.py; reference:
DEX-TTS/preprocess/preprocess.py:9-30 plus the make_file/ filelist
builders in one pass):

  python -m dex_tts_tpu_torch.preprocess --dataset VCTK \\
      --corpus_path /data/VCTK-Corpus --out_path ./preprocessed/VCTK \\
      --filelist_dir filelists/VCTK --n_random_unseen 10 [--device cuda]

The log-mels run on ``--device`` (CUDA by default; without a card it
raises unless ``--device cpu``), before anything is written.
"""

from __future__ import annotations

import argparse

from dex_tts_tpu_torch.preprocess.filelists import make_filelist
from dex_tts_tpu_torch.preprocess.preprocessor import (
    PreprocessConfig,
    Preprocessor,
    prepare_align,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m dex_tts_tpu_torch.preprocess")
    p.add_argument("--dataset", required=True, choices=["LJSpeech", "VCTK", "ESD", "LibriTTS"])
    p.add_argument("--corpus_path", required=True)
    p.add_argument("--raw_path", default="./raw_data")
    p.add_argument("--out_path", default="./preprocessed")
    p.add_argument("--filelist_dir", default=None)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--skip_align", action="store_true")
    p.add_argument("--unseen_spk", type=int, nargs="*", default=None)
    p.add_argument("--n_random_unseen", type=int, default=0)
    p.add_argument("--min_frames", type=int, default=0)
    p.add_argument("--max_frames", type=int, default=10**9)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", default=None, help="device of the log-mels (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> tuple[list[dict], dict | None]:
    """→ (the metadata rows, the filelist counts or None)."""
    args = parse_args(argv)
    cfg = PreprocessConfig(
        corpus_path=args.corpus_path,
        raw_path=args.raw_path,
        out_path=args.out_path,
        sample_rate=args.sample_rate,
    )
    preprocessor = Preprocessor(cfg, device=args.device)  # raises without CUDA first
    if not args.skip_align:
        print(f"prepare_align({args.dataset}) ...")
        prepare_align(args.dataset, cfg)
    print(f"extracting mel/lf0 on {preprocessor.device} ...")
    rows = preprocessor.build_from_path()
    print(f"processed {len(rows)} utterances")
    counts = None
    if args.filelist_dir:
        counts = make_filelist(
            rows,
            args.filelist_dir,
            dataset=args.dataset,
            unseen_speakers=args.unseen_spk,
            n_random_unseen=args.n_random_unseen,
            min_frames=args.min_frames,
            max_frames=args.max_frames,
            seed=args.seed,
        )
        print("filelists:", counts)
    return rows, counts


if __name__ == "__main__":
    main()
