"""One closed-loop caller of the program's `pipeline.Synthesizer.tts`, as
a corpus job sends its batches: the next call goes as soon as the last
returned. A traffic file names it as ``"driver": "closed_loop_synthesis"``
and gives the generator's parameters (`benchmark.traffic`).

The Synthesizer holds the configuration's parts ``tts`` and ``vocoder``
and its ``synthesizer`` settings (buckets, batch padding, blanks, the
CMUdict), its sampler set to the traffic's solver and steps. Set-up
makes one call at each (text bucket, frame bucket) that the traffic's
batches reach; the window cycles through the batches, each call with a
noise seed of its own. The check compares one call of the window, drawn
from the seed, with the plain reference (`benchmark.check`).
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from benchmark import check, spans
from benchmark import traffic as gen
from benchmark.weights import derive_seed

CHECK_TAG, WARMUP_TAG = 5, 6


class Driver:
    def __init__(self, config: dict, traffic: dict, parts: dict, seed: int, device, root: str,
                 trace: bool):
        from dex_tts_tpu_torch.models.edm import SamplerConfig
        from dex_tts_tpu_torch.pipeline import Synthesizer

        s = config["synthesizer"]
        cmu = config.get("cmu_path")
        self.synth = Synthesizer(
            parts["tts"], parts["vocoder"], cmu_path=os.path.join(root, cmu) if cmu else None,
            sampler=SamplerConfig(num_steps=traffic["steps"], solver=traffic["solver"]),
            device=device, add_blank=s["add_blank"], x_quantum=s["x_quantum"],
            y_quantum=s["y_quantum"], pad_batches=s["pad_batches"])
        self.config, self.traffic, self.seed, self.device, self.root = (
            config, traffic, seed, device, root)
        self.sample_rate = s["sample_rate"]
        self.hop = math.prod(config["vocoder"]["upsample_rates"])
        self.batches = gen.batches(traffic, seed, config["tts"]["use_style"],
                                   config["tts"]["n_feats"])
        self.rec = spans.Recorder(self.synth, layer_spans=trace)
        self.outputs: list = []
        self.window_calls: list[dict] = []

    def _call(self, batch: dict, noise_seed: int) -> list[dict]:
        tr = self.traffic
        self.rec.begin_call()
        t0 = time.perf_counter()
        out = self.synth.tts(batch["texts"],
                             generator=torch.Generator(self.device).manual_seed(noise_seed),
                             ref_feats=batch["ref_feats"], n_timesteps=tr["steps"],
                             solver=tr["solver"], temperature=tr["temperature"],
                             max_frames=tr["max_frames"])
        wall = time.perf_counter() - t0
        # the audio the call returned, as long as it came back
        self.rec.end_call().update(
            wall_s=wall, audio_s=sum(len(o["wav"]) for o in out) / self.sample_rate)
        return out

    def warm_up(self) -> None:
        """One call at each distinct (text bucket, frame bucket) of the
        traffic's batches."""
        shapes = {}
        for i, b in enumerate(self.batches):
            inputs, _ = self.synth.prepare_batch(b["texts"], ref_feats=b["ref_feats"])
            bucket = self.synth.frame_bucket(inputs, max_frames=self.traffic["max_frames"])
            shapes.setdefault((inputs["x"].shape, bucket), i)
        for k, i in enumerate(shapes.values()):
            self._call(self.batches[i], derive_seed(self.seed, WARMUP_TAG, k))
        self.rec.calls.clear()

    def window(self, seconds: float) -> tuple[float, list[dict]]:
        """Calls back to back until ``seconds`` have passed → (the wall
        time of all of them, one record per call)."""
        t_start = time.perf_counter()
        while True:
            i = len(self.outputs)
            self.outputs.append(self._call(self.batches[i % len(self.batches)],
                                           gen.call_seed(self.seed, i)))
            window_s = time.perf_counter() - t_start
            if window_s >= seconds:
                break
        self.window_calls = list(self.rec.calls)
        return window_s, self.window_calls

    def attempted(self) -> int:
        """Sentences sent in the window."""
        return len(self.outputs) * self.traffic["batch"]

    def profiled_call(self) -> None:
        self._call(self.batches[0], gen.call_seed(self.seed, len(self.outputs)))

    def check(self, count_flops: bool = False, control: bool = False):
        """Frees the program, then compares one call of the window, drawn
        from the seed, with the reference → (the numbers compared, with
        the control's under ``control`` where asked; the reference's
        FLOPs for the call, or None)."""
        k = int(np.random.default_rng(derive_seed(self.seed, CHECK_TAG))
                .integers(len(self.outputs)))
        record, got = self.window_calls[k], self.outputs[k]
        batch = self.batches[k % len(self.batches)]
        self.synth = self.rec = self.outputs = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        args = (self.config, self.traffic, self.seed, gen.call_seed(self.seed, k), batch)
        ref, wav_ref, flops = check.reference_call(
            *args, [o["mel"] for o in got], record["bucket"], self.device, self.root,
            count_flops=count_flops)
        values = check.numbers(record, got, ref, wav_ref, self.hop, per_item=control)
        if control:
            values["control"] = check.control_numbers(*args, ref, self.device, self.root,
                                                      self.hop)
        return values, flops
