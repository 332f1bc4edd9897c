"""Micro-batching TTS serving: queue + batcher + stdlib HTTP front end
(port of dex_tts_tpu/serving.py; numpy and the standard library, the
pipeline imported lazily).

The reference has no serving story (one-shot synthesize.py only —
reference: DEX-TTS/synthesize.py:115-138). A short request alone leaves
the card mostly idle (its 50 sampler steps are bound by kernel launches
from Python), so one 50-step `Synthesizer.tts` call should carry every
sentence that is waiting: a server coalesces concurrent requests.

`MicroBatcher` is the core: callers `submit()` individual sentences and
block on a future; a worker thread drains the queue into batches of up to
`max_batch`, waiting at most `max_wait_ms` for stragglers, and runs the
whole batch through one `Synthesizer.tts` call. The admission queue is BOUNDED
(`max_queue`, default 8×max_batch): under sustained overload submit()
raises QueueFull and the HTTP layer fast-rejects with 503 + Retry-After
instead of accumulating futures until client timeouts; /healthz exposes
queue_depth / max_queue / rejected for capacity monitoring. `TTSRequestHandler`/`make_server` wrap it in
a dependency-free HTTP JSON API:

    POST /tts     {"texts": ["...", ...]}  →  {"wavs": [b64 int16], ...}
    POST /tts     {"text": "paragraph...", "pause_ms": 200}
                  → sentences split server-side (pipeline.split_sentences),
                    synthesized through the same batching queue, and
                    concatenated into ONE wav with pauses → {"wavs": [b64]}
    POST /tts_stream  {"text": "paragraph...", "pause_ms": 200}
                  → chunked NDJSON stream: one {"i", "pcm", "samples"}
                    line per sentence as it is synthesized (first audio
                    after ONE small batch, not the whole article — waves
                    ramp 1→2→4→…→max_batch), then a final {"done": true}
                    line with totals. Wave k+1 is submitted before wave
                    k's audio is written, so synthesis overlaps the
                    network I/O.
    GET  /healthz                          →  {"ok": true, ...}

Queue order is earliest deadline first: an urgent entry (a stream's
first wave) is due when it arrives, every other entry (a /tts request, a
stream's continuation wave) `AGING_WAITS` linger windows after it
arrives. Urgent first waves therefore jump a fresh backlog, FIFO order
holds within each class, and a continuation wave that has waited longer
than the bound goes before urgent waves that arrived after its bound
ran out. The JAX package's strict two-class priority lets a sustained
stream of urgent first waves starve continuation waves (ADVICE.md, round 5).

Run via `python -m dex_tts_tpu_torch.serve`.
"""

from __future__ import annotations

import base64
import itertools
import json
import math
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# a non-urgent entry is due this many linger windows (max_wait_ms) after
# it arrives: 1 s at the default 25 ms. Urgent first waves that arrive
# before then go first; after it, the entry goes before newer ones.
AGING_WAITS = 40


class QueueFull(RuntimeError):
    """Raised by MicroBatcher.submit when the admission queue is at
    capacity — the server maps it to HTTP 503 + Retry-After instead of
    letting futures pile up behind a ~seconds-per-dispatch accelerator."""


class MicroBatcher:
    """Coalesce concurrent single-sentence requests into batched calls.

    infer_fn: list[str] -> list[dict] (one result per sentence, any
    payload — the server uses Synthesizer.tts outputs)."""

    def __init__(
        self,
        infer_fn,
        max_batch: int = 16,
        max_wait_ms: float = 25.0,
        split_length_ratio: float = 2.0,
        max_queue: int | None = None,
    ):
        self.infer_fn = infer_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # backpressure: bound the admission queue so sustained overload
        # fast-rejects (QueueFull → HTTP 503) instead of accepting every
        # request and letting futures dangle until client timeouts.
        # Default depth = a few dispatches' worth of work; 0 disables.
        self.max_queue = 8 * max_batch if max_queue is None else max_queue
        self.rejected = 0  # observability (/healthz)
        # length-aware batching: Synthesizer pads every sentence in a batch
        # to the longest one's text/frame bucket, so co-batching a 10-word
        # and a 200-word request wastes ~longest/shortest of the compute.
        # When the collected batch's max/min text length exceeds this ratio
        # it is split at the largest relative length gap into two groups
        # (each its own `tts` call). 0 disables.
        self.split_length_ratio = split_length_ratio
        self.batch_sizes: list[int] = []  # observability / tests
        # deadline queue: an urgent entry (a stream's FIRST wave, whose
        # latency IS the time-to-first-audio) is due on arrival, any other
        # entry aging_s later, so urgent waves jump a fresh normal backlog
        # but cannot starve it; a monotone sequence number keeps FIFO
        # order within each class and breaks ties without comparing
        # futures. Receipt motivating the jump: the JAX package's BigVGAN
        # load test on a TPU showed TTFA collapsing 581 ms → 4.4 s at 16
        # concurrent streams from queue wait behind bulk waves.
        self.aging_s = AGING_WAITS * self.max_wait_s
        self._q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, text: str, urgent: bool = False) -> Future:
        """Enqueue one sentence. After close() the future fails fast
        instead of dangling for the full client timeout (the lock closes
        the check-then-enqueue race against close()). Raises QueueFull
        when the bounded queue is at capacity (the lock also serializes
        the depth check against concurrent submitters; the worker only
        ever shrinks the queue). ``urgent=True`` (a stream's first wave)
        jumps normal entries that arrived less than ``aging_s`` before it
        — see the queue comment in __init__."""
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(RuntimeError("server shutting down"))
                return fut
            if self.max_queue and self._q.qsize() >= self.max_queue:
                self.rejected += 1
                raise QueueFull(
                    f"queue full ({self.max_queue} pending requests)"
                )
            due = time.monotonic() + (0.0 if urgent else self.aging_s)
            self._q.put((due, next(self._seq), text, fut))
        return fut

    def queue_depth(self) -> int:
        """Current admission-queue depth (approximate under concurrency)."""
        return self._q.qsize()

    def close(self):
        """Stop the worker and fail still-queued requests.

        The batch being collected when the stop lands is still served
        (`_collect` returns it on the wake sentinel); anything queued
        after that gets a fast error instead of a 600 s future timeout,
        and later submit() calls fail fast (see submit).
        """
        with self._submit_lock:
            self._stop.set()
        self._q.put((-math.inf, next(self._seq), None, None))  # wake the worker
        self._worker.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item[2] is None:
                continue
            fut = item[3]
            if not fut.done():
                fut.set_exception(RuntimeError("server shutting down"))

    def _collect(self) -> list:
        """Block for the first request, then linger up to max_wait_s for
        more (or until max_batch)."""
        first = self._q.get()
        if first[2] is None:
            return []
        batch = [(first[2], first[3])]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item[2] is None:
                break
            batch.append((item[2], item[3]))
        return batch

    def _split_by_length(self, batch: list) -> list[list]:
        """Split a collected batch at the largest relative text-length gap
        when the longest/shortest ratio exceeds split_length_ratio."""
        if self.split_length_ratio <= 0 or len(batch) < 2:
            return [batch]
        ordered = sorted(batch, key=lambda item: len(item[0]))
        lo = max(len(ordered[0][0]), 1)  # empty text must not disable this
        hi = max(len(ordered[-1][0]), 1)
        if hi / lo <= self.split_length_ratio:
            return [batch]
        gaps = [
            len(ordered[i + 1][0]) / max(len(ordered[i][0]), 1)
            for i in range(len(ordered) - 1)
        ]
        cut = gaps.index(max(gaps)) + 1
        # recurse: a batch spanning three length clusters needs more than
        # one cut (e.g. [4, 40, 400] chars)
        return self._split_by_length(ordered[:cut]) + self._split_by_length(
            ordered[cut:]
        )

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            for group in self._split_by_length(batch):
                self._serve_group(group)

    def _serve_group(self, batch: list):
        # claim each future (PENDING→RUNNING); a future the client already
        # cancelled (e.g. a streaming request whose socket died) is dropped
        # here, BEFORE its sentence costs a 50-step sampler dispatch
        live = [
            (t, fut) for t, fut in batch if fut.set_running_or_notify_cancel()
        ]
        if not live:
            return
        texts = [t for t, _ in live]
        self.batch_sizes.append(len(texts))
        try:
            results = self.infer_fn(texts)
            if len(results) != len(texts):
                raise RuntimeError(
                    f"infer_fn returned {len(results)} results for "
                    f"{len(texts)} texts"
                )
            for (_, fut), res in zip(live, results):
                fut.set_result(res)
        except Exception:
            # one bad sentence must not poison its co-batched peers:
            # retry each item alone so only the real offender fails
            for t, fut in live:
                if fut.done():
                    continue
                try:
                    res = self.infer_fn([t])
                    if len(res) != 1:
                        raise RuntimeError(
                            f"infer_fn returned {len(res)} results "
                            "for 1 text"
                        )
                    fut.set_result(res[0])
                except Exception as e:
                    fut.set_exception(e)


def _submit_all(
    batcher: MicroBatcher, texts: list, urgent: bool = False
) -> list:
    """Submit every sentence or none: on QueueFull mid-loop, cancel the
    already-submitted futures (honored for still-queued items, see
    MicroBatcher._serve_group) so a rejected request leaves no orphaned
    work behind, then re-raise for the 503 path."""
    futs: list[Future] = []
    try:
        for t in texts:
            futs.append(batcher.submit(t, urgent=urgent))
    except QueueFull:
        for f in futs:
            f.cancel()
        raise
    return futs


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile: ceil(q·n)−1 (int(q·n) is off by one —
    p95 of a 20-sample window would report the maximum)."""
    import math

    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]


def _validate_long_text(req: dict) -> tuple[str, float]:
    """Shared validation for the long-form endpoints (/tts with "text",
    /tts_stream): returns (text, pause_ms) or raises ValueError with the
    client-facing message."""
    text = req.get("text")
    if not isinstance(text, str) or not text.strip():
        raise ValueError("text: non-empty string")
    raw_pause = req.get("pause_ms", 200.0)
    if (
        not isinstance(raw_pause, (int, float))
        or isinstance(raw_pause, bool)
        or not 0 <= raw_pause <= 10_000
    ):
        raise ValueError("pause_ms: number in [0, 10000]")
    return text, float(raw_pause)


def wav_to_b64(wav: np.ndarray) -> str:
    """float [-1,1] → base64 of int16 little-endian PCM (the reference's
    output sample format, DEX-TTS/synthesize.py:104-112)."""
    scaled = np.asarray(wav, np.float32) * 32768.0
    pcm = np.clip(scaled, -32768, 32767).astype("<i2")  # 1.0 must not wrap
    return base64.b64encode(pcm.tobytes()).decode("ascii")


def make_server(
    batcher: MicroBatcher,
    host: str = "127.0.0.1",
    port: int = 8901,
    sample_rate: int = 22050,
    info: dict | None = None,
) -> ThreadingHTTPServer:
    """HTTP front end over a MicroBatcher. Request threads block on their
    futures; batching happens in the worker regardless of which thread
    carried which request."""
    stats = {"requests": 0, "sentences": 0}
    # rolling windows of per-request wall-clock → p50/p95 in /healthz.
    # /tts and /tts_stream are tracked SEPARATELY: a whole-article stream's
    # wall time is dominated by article length, and mixing it into the
    # single-shot window would make the p95 bimodal and meaningless.
    from collections import deque

    stats_lock = threading.Lock()
    latencies = {
        "tts": deque(maxlen=200),
        "tts_stream": deque(maxlen=200),
    }
    srv_info = dict(info or {})

    def _record(endpoint: str, wall: float, sentences: int):
        with stats_lock:
            stats["requests"] += 1
            stats["sentences"] += sentences
            latencies[endpoint].append(wall)

    def _latency_stats() -> dict:
        with stats_lock:  # snapshot under the lock: request threads append
            snap = {k: sorted(v) for k, v in latencies.items()}
        out = {}
        for endpoint, prefix in (("tts", "latency"), ("tts_stream", "stream")):
            vals = snap[endpoint]
            if vals:
                out[f"{prefix}_p50_ms"] = round(_percentile(vals, 0.50) * 1e3, 1)
                out[f"{prefix}_p95_ms"] = round(_percentile(vals, 0.95) * 1e3, 1)
        return out

    class TTSRequestHandler(BaseHTTPRequestHandler):
        # chunked transfer encoding (the /tts_stream response) requires 1.1
        protocol_version = "HTTP/1.1"
        # HTTP/1.1 defaults to keep-alive; without a socket timeout every
        # idle client connection would pin its server thread forever
        # (handle_one_request closes the connection when the read times out)
        timeout = 65

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict, headers: dict | None = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reject_overload(self, e: QueueFull):
            """503 + Retry-After: roughly one max_batch dispatch's worth
            of queue drain (clients should back off, not hammer)."""
            return self._json(
                503,
                {"error": str(e), "queue_depth": batcher.queue_depth()},
                headers={"Retry-After": "5"},
            )

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            with stats_lock:
                counts = dict(stats)
            self._json(
                200,
                {
                    "ok": True,
                    "batch_sizes": batcher.batch_sizes[-20:],
                    "queue_depth": batcher.queue_depth(),
                    "max_queue": batcher.max_queue,
                    "rejected": batcher.rejected,
                    **counts,
                    **_latency_stats(),
                    **srv_info,
                },
            )

        def _write_chunk(self, data: bytes):
            """One HTTP/1.1 chunked-transfer frame (http.server does not
            chunk for us)."""
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def do_POST(self):
            if self.path == "/tts_stream":
                return self._tts_stream()
            if self.path != "/tts":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                long_text = req.get("text")
                pause_ms = 200.0
                if long_text is not None:
                    long_text, pause_ms = _validate_long_text(req)
                    from dex_tts_tpu_torch.pipeline import split_sentences

                    texts = split_sentences(long_text)
                else:
                    texts = req.get("texts") or []
                if (
                    not isinstance(texts, list)
                    or not texts
                    or not all(
                        isinstance(t, str) and t.strip() for t in texts
                    )
                ):
                    return self._json(
                        400, {"error": "texts: non-empty list of strings"}
                    )
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})

            t0 = time.monotonic()
            try:
                futs = _submit_all(batcher, texts)
            except QueueFull as e:
                return self._reject_overload(e)
            try:
                outs = [f.result(timeout=600) for f in futs]
            except Exception as e:
                return self._json(500, {"error": repr(e)})
            if long_text is not None:
                # one wav: sentences joined with pause_ms of silence
                gap = np.zeros(int(sample_rate * pause_ms / 1e3), np.float32)
                parts = []
                for i, o in enumerate(outs):
                    if i:
                        parts.append(gap)
                    parts.append(np.asarray(o["wav"], np.float32))
                outs = [{"wav": np.concatenate(parts)}]
            wavs = [wav_to_b64(o["wav"]) for o in outs]
            audio_s = sum(len(o["wav"]) for o in outs) / sample_rate
            wall = time.monotonic() - t0
            _record("tts", wall, len(texts))
            self._json(
                200,
                {
                    "wavs": wavs,
                    "sample_rate": sample_rate,
                    "audio_seconds": round(audio_s, 3),
                    "rtf": round(wall / audio_s, 5) if audio_s else None,
                },
            )

        def _tts_stream(self):
            """Chunked NDJSON streaming synthesis of one long text.

            Sentences go through the shared MicroBatcher in ramped waves
            (1, 2, 4, … max_batch): the first audio line is written after
            a single-sentence batch instead of the full article, and wave
            k+1 is already queued while wave k's PCM is on the wire, so
            the device never idles behind the socket."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            try:
                text, pause_ms = _validate_long_text(req)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            pause = np.zeros(int(sample_rate * pause_ms / 1e3), np.float32)
            from dex_tts_tpu_torch.pipeline import ramp_spans, split_sentences

            sentences = split_sentences(text)
            if not sentences:
                return self._json(400, {"error": "no synthesizable text"})

            waves = ramp_spans(len(sentences), batcher.max_batch)

            # admission control happens BEFORE the 200 goes on the wire:
            # an overloaded queue turns the whole stream away with a clean
            # 503 the client can retry
            t0 = time.monotonic()
            try:
                # first wave = the stream's time-to-first-audio: jump the
                # bulk backlog (the JAX package's TPU load test: TTFA
                # 581 ms -> 4.4 s at 16 concurrent streams from queue wait)
                futs = _submit_all(
                    batcher, sentences[waves[0][0] : waves[0][1]],
                    urgent=True,
                )
            except QueueFull as e:
                return self._reject_overload(e)

            def _submit_wave(lo, hi, deadline_s=60.0):
                # mid-stream the request is already admitted; under
                # transient overload from other clients, wait for queue
                # drain instead of killing a half-delivered stream
                t_end = time.monotonic() + deadline_s
                while True:
                    try:
                        return _submit_all(batcher, sentences[lo:hi])
                    except QueueFull:
                        if time.monotonic() >= t_end:
                            raise
                        time.sleep(0.05)

            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Sample-Rate", str(sample_rate))
            self.end_headers()

            total_samples = 0
            try:
                for k, (lo, hi) in enumerate(waves):
                    outs = [f.result(timeout=600) for f in futs]
                    futs = []
                    if k + 1 < len(waves):
                        futs = _submit_wave(*waves[k + 1])
                    for i, o in zip(range(lo, hi), outs):
                        wav = np.asarray(o["wav"], np.float32)
                        if i and pause.size:
                            wav = np.concatenate([pause, wav])
                        total_samples += wav.size
                        self._write_chunk(
                            json.dumps(
                                {
                                    "i": i,
                                    "pcm": wav_to_b64(wav),
                                    "samples": int(wav.size),
                                }
                            ).encode()
                            + b"\n"
                        )
                audio_s = total_samples / sample_rate
                wall = time.monotonic() - t0
                _record("tts_stream", wall, len(sentences))
                self._write_chunk(
                    json.dumps(
                        {
                            "done": True,
                            "sentences": len(sentences),
                            "sample_rate": sample_rate,
                            "audio_seconds": round(audio_s, 3),
                            "rtf": (
                                round(wall / audio_s, 5) if audio_s else None
                            ),
                        }
                    ).encode()
                    + b"\n"
                )
            except Exception as e:
                # already-submitted next-wave sentences are audio nobody
                # will read — cancel them (honored for still-queued items,
                # see MicroBatcher._serve_group) so the device doesn't burn
                # sampler dispatches for a dead client
                for f in futs:
                    f.cancel()
                # the 200 header is already on the wire — report the
                # failure in-band as the stream's last line
                try:
                    self._write_chunk(
                        json.dumps({"error": repr(e)}).encode() + b"\n"
                    )
                except OSError:
                    pass
            try:
                self.wfile.write(b"0\r\n\r\n")  # end of chunked stream
            except OSError:
                pass

    return ThreadingHTTPServer((host, port), TTSRequestHandler)
