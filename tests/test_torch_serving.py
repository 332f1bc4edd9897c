"""The port's micro-batching server (dex_tts_tpu_torch/serving.py): the
cases of tests/test_serving.py on the same stub infer, the port's batcher
against the JAX package's on one arrival sequence, the repaired
starvation of continuation waves, and the `synthesize` and `serve`
entry points on a tiny preset on the CPU."""

import base64
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.serving import MicroBatcher as JaxMicroBatcher  # noqa: E402
from dex_tts_tpu_torch import serve, synthesize  # noqa: E402
from dex_tts_tpu_torch.audio.wav import read_wav  # noqa: E402
from dex_tts_tpu_torch.config import PRESETS, Preset  # noqa: E402
from dex_tts_tpu_torch.eval.evaluation import load_synthesizer  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig, HiFiGANGenerator  # noqa: E402
from dex_tts_tpu_torch.serving import AGING_WAITS, MicroBatcher, make_server, wav_to_b64  # noqa: E402
from dex_tts_tpu_torch.train import create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from tests.torch_port_util import tiny_cfg  # noqa: E402

# rates (8, 8, 4): hop 256, as the Synthesizer's frames assume
TINY_VOC = dict(num_mels=12, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def tiny_experiment(tmp_path_factory):
    """A tiny GeDEX (one speaker, no style) saved through the port's
    CheckpointManager as ``best-train``, and a tiny HiFi-GAN in the
    reference layout with its config.json → (preset, exp_dir). Every
    weight is moved by seeded noise, so the audio depends on the
    sampler's noise (zero-initialised output layers would hide it)."""
    root = tmp_path_factory.mktemp("tiny")
    exp_dir, voc_dir = str(root / "exp"), str(root / "voc")
    os.makedirs(voc_dir)
    torch.manual_seed(0)
    model = build_tts(tiny_cfg(use_style=False))
    vocoder = HiFiGANGenerator(HiFiGANConfig(**TINY_VOC))
    with torch.no_grad():
        for scale, module in ((0.05, model), (0.3, vocoder)):
            for p in module.parameters():
                p.add_(scale * torch.randn(p.shape))
    CheckpointManager(os.path.join(exp_dir, "ckpt")).save(create_train_state(model), "best-train")
    torch.save({"generator": vocoder.state_dict()},
               os.path.join(voc_dir, "generator_universal.pth.tar"))
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump(TINY_VOC, f)
    preset = Preset(model=tiny_cfg(use_style=False), vocoder_path=voc_dir)
    return preset, exp_dir


def slow_infer(calls, delay=0.05):
    def infer(texts):
        calls.append(list(texts))
        time.sleep(delay)
        return [
            {"wav": np.full((100,), 0.5, np.float32), "text": t}
            for t in texts
        ]

    return infer


def test_microbatcher_coalesces_concurrent_requests():
    calls = []
    b = MicroBatcher(slow_infer(calls), max_batch=8, max_wait_ms=80)
    try:
        futs = [b.submit(f"s{i}") for i in range(6)]
        outs = [f.result(timeout=10) for f in futs]
    finally:
        b.close()
    assert [o["text"] for o in outs] == [f"s{i}" for i in range(6)]
    # 6 submissions within the linger window → far fewer infer calls
    assert len(calls) <= 2
    assert sum(len(c) for c in calls) == 6


def test_microbatcher_respects_max_batch():
    calls = []
    b = MicroBatcher(slow_infer(calls, delay=0.0), max_batch=2,
                     max_wait_ms=60)
    try:
        futs = [b.submit(f"s{i}") for i in range(5)]
        [f.result(timeout=10) for f in futs]
    finally:
        b.close()
    assert all(len(c) <= 2 for c in calls)


def test_microbatcher_skips_cancelled_futures():
    """A future cancelled while queued (client hung up mid-stream) must not
    cost an infer dispatch; live peers in the same batch still get served.
    All-cancelled batches skip the infer call entirely."""
    calls = []
    b = MicroBatcher(slow_infer(calls), max_batch=8)
    try:
        from concurrent.futures import Future

        dead, live = Future(), Future()
        assert dead.cancel()
        b._serve_group([("gone", dead), ("here", live)])
        assert calls == [["here"]]
        assert live.result(timeout=10)["text"] == "here"

        dead2 = Future()
        assert dead2.cancel()
        b._serve_group([("gone2", dead2)])
        assert calls == [["here"]]  # no infer call for an empty batch
    finally:
        b.close()


def test_microbatcher_propagates_errors():
    def boom(texts):
        raise RuntimeError("graph exploded")

    b = MicroBatcher(boom, max_batch=4, max_wait_ms=10)
    try:
        f = b.submit("hello")
        with pytest.raises(RuntimeError, match="graph exploded"):
            f.result(timeout=10)
    finally:
        b.close()
    # the worker survives a failing batch
    f2 = MicroBatcher(slow_infer([], 0.0), max_wait_ms=5).submit("x")
    assert f2.result(timeout=10)["text"] == "x"


@pytest.fixture()
def server():
    calls = []
    b = MicroBatcher(slow_infer(calls), max_batch=8, max_wait_ms=40)
    srv = make_server(b, port=0, sample_rate=22050, info={"backend": "cpu"})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, calls
    srv.shutdown()
    b.close()


def _post(port, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tts",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_tts_roundtrip(server):
    srv, calls = server
    port = srv.server_address[1]
    code, out = _post(port, {"texts": ["hello world", "second"]})
    assert code == 200
    assert len(out["wavs"]) == 2 and out["sample_rate"] == 22050
    pcm = np.frombuffer(base64.b64decode(out["wavs"][0]), dtype="<i2")
    assert pcm.shape == (100,) and abs(pcm[0] / 32768.0 - 0.5) < 1e-3
    assert out["rtf"] is not None and out["audio_seconds"] > 0

    # concurrent clients coalesce into shared batches
    results = []
    threads = [
        threading.Thread(
            target=lambda i=i: results.append(
                _post(port, {"texts": [f"c{i}"]})
            )
        )
        for i in range(4)
    ]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert all(code == 200 for code, _ in results)
    assert max(len(c) for c in calls) >= 2  # batching actually happened

    # health endpoint reports stats
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    ) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["backend"] == "cpu" and h["sentences"] >= 6


def test_http_bad_requests(server):
    srv, _ = server
    port = srv.server_address[1]
    assert _post(port, {})[0] == 400
    assert _post(port, {"texts": "not a list"})[0] == 400
    assert _post(port, {"texts": [""]})[0] == 400
    code, _ = _post(port, {"texts": [123]})
    assert code == 400


def test_wav_to_b64_clamps():
    wav = np.asarray([2.0, -2.0, 0.0], np.float32)
    pcm = np.frombuffer(base64.b64decode(wav_to_b64(wav)), dtype="<i2")
    assert pcm[0] == 32767 and pcm[1] == -32768 and pcm[2] == 0


def test_serve_end_to_end_tiny(tiny_experiment):
    """Full serving stack over a real (tiny, random-weight) GeDEX model:
    checkpoint → load_synthesizer → MicroBatcher → HTTP → decodable wav."""
    preset, exp_dir = tiny_experiment
    synth = load_synthesizer(preset, exp_dir, n_timesteps=2, device="cpu")
    generator = torch.Generator().manual_seed(0)

    def infer(texts):
        return synth.tts(texts, generator=generator)

    b = MicroBatcher(infer, max_batch=4, max_wait_ms=30)
    srv = make_server(b, port=0, sample_rate=22050)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        code, out = _post(
            port, {"texts": ["hello there", "go now"]}, timeout=600
        )
        assert code == 200 and len(out["wavs"]) == 2
        pcm = np.frombuffer(base64.b64decode(out["wavs"][0]), dtype="<i2")
        assert pcm.size >= 256 * 16  # at least one frame bucket of audio
        assert np.isfinite(pcm.astype(np.float32)).all()
    finally:
        srv.shutdown()
        b.close()


def test_microbatcher_isolates_poison_requests():
    """One failing sentence must not 500 its co-batched peers: the batch
    is retried per item and only the offender gets the exception."""
    def infer(texts):
        if any(t == "poison" for t in texts):
            raise RuntimeError("bad sentence")
        return [{"wav": np.zeros(10, np.float32), "text": t} for t in texts]

    b = MicroBatcher(infer, max_batch=8, max_wait_ms=80)
    try:
        futs = {t: b.submit(t) for t in ["good1", "poison", "good2"]}
        assert futs["good1"].result(timeout=10)["text"] == "good1"
        assert futs["good2"].result(timeout=10)["text"] == "good2"
        with pytest.raises(RuntimeError, match="bad sentence"):
            futs["poison"].result(timeout=10)
    finally:
        b.close()


def test_microbatcher_result_count_mismatch():
    def short(texts):
        return [{"wav": np.zeros(4, np.float32)}] * (len(texts) - 1)

    b = MicroBatcher(short, max_batch=4, max_wait_ms=40)
    try:
        futs = [b.submit(f"t{i}") for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="returned"):
                f.result(timeout=10)
    finally:
        b.close()


def test_close_fails_queued_requests_fast():
    """Graceful shutdown: the batch in flight when close() lands is still
    served; requests still queued behind it fail immediately with
    'server shutting down' instead of hanging to the future timeout."""
    release = threading.Event()
    calls = []

    def blocking_infer(texts):
        calls.append(list(texts))
        release.wait(timeout=5)
        return [{"text": t} for t in texts]

    b = MicroBatcher(blocking_infer, max_batch=1, max_wait_ms=5)
    f1 = b.submit("a")  # enters the worker, blocks in infer
    while not calls:
        time.sleep(0.005)
    f2 = b.submit("b")  # sits in the queue behind it

    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.05)
    release.set()  # let the in-flight batch finish
    closer.join(timeout=5)
    assert not closer.is_alive()

    assert f1.result(timeout=5) == {"text": "a"}
    with pytest.raises(RuntimeError, match="shutting down"):
        f2.result(timeout=5)


def test_length_aware_batch_split():
    """A batch mixing short and long sentences splits at the largest
    length gap (each group its own dispatch); homogeneous batches stay
    whole; results still land on the right futures."""
    # the splitter itself is a pure function — test it deterministically
    mb = MicroBatcher(lambda ts: [{"t": t} for t in ts],
                      split_length_ratio=2.0)
    try:
        items = [("a" * 40, None), ("hi", None), ("b" * 44, None),
                 ("ok", None)]
        groups = mb._split_by_length(items)
        assert [sorted(t for t, _ in g) for g in groups] == [
            ["hi", "ok"], ["a" * 40, "b" * 44]
        ]
        same = [("medium one", None), ("medium two", None)]
        assert mb._split_by_length(same) == [same]
        assert mb._split_by_length(items[:1]) == [items[:1]]
    finally:
        mb.close()

    # integration: served through the worker, futures map back correctly
    # and no dispatch mixes a short with a long sentence
    calls = []

    def infer(texts):
        calls.append(list(texts))
        return [{"text": t} for t in texts]

    mb = MicroBatcher(infer, max_batch=8, max_wait_ms=40.0,
                      split_length_ratio=2.0)
    try:
        texts = ["hi", "ok", "a" * 40, "b" * 44]
        futs = [mb.submit(t) for t in texts]
        outs = [f.result(timeout=30) for f in futs]
        for t, o in zip(texts, outs):
            assert o["text"] == t
        assert sum(len(c) for c in calls) == 4
        assert len(calls) >= 2, calls  # the mixed batch was split
        for c in calls:
            assert not (min(map(len, c)) < 10 < 30 < max(map(len, c))), c
    finally:
        mb.close()


def test_submit_after_close_fails_fast():
    mb = MicroBatcher(lambda ts: [{"t": t} for t in ts], max_wait_ms=5.0)
    mb.close()
    fut = mb.submit("late")
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


def test_http_long_text_splits_and_concatenates(server):
    """POST {"text": paragraph} splits into sentences server-side, rides
    the same batching queue, and returns ONE wav with pause_ms silences."""
    srv, calls = server
    port = srv.server_address[1]
    code, out = _post(
        port, {"text": "First sentence. Second one! Third?", "pause_ms": 100}
    )
    assert code == 200
    assert len(out["wavs"]) == 1
    pcm = np.frombuffer(base64.b64decode(out["wavs"][0]), dtype="<i2")
    gap = int(22050 * 0.1)
    # 3 fake 100-sample wavs + 2 gaps
    assert pcm.shape == (3 * 100 + 2 * gap,)
    # the gaps are silent, the sentences are not
    assert pcm[100 : 100 + gap].max() == 0
    assert abs(pcm[0] / 32768.0 - 0.5) < 1e-3
    # all three sentences went through the batcher (possibly coalesced)
    assert sum(len(c) for c in calls[-3:]) >= 3

    assert _post(port, {"text": "   "})[0] == 400
    assert _post(port, {"text": 42})[0] == 400


def test_http_long_text_pause_ms_validation(server):
    srv, _ = server
    port = srv.server_address[1]
    assert _post(port, {"text": "Hi.", "pause_ms": None})[0] == 400
    assert _post(port, {"text": "Hi.", "pause_ms": -5})[0] == 400
    assert _post(port, {"text": "Hi.", "pause_ms": 1e12})[0] == 400
    assert _post(port, {"text": "Hi.", "pause_ms": True})[0] == 400
    # pause_ms is ignored (not validated) on the texts path
    assert _post(port, {"texts": ["ok"], "pause_ms": "junk"})[0] == 200
    assert _post(port, {"text": "Hi.", "pause_ms": 0})[0] == 200


def _post_stream(port, payload, timeout=30):
    """POST to /tts_stream, return (status, [parsed NDJSON lines])."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tts_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, [json.loads(l) for l in r if l.strip()]
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())]


def test_http_tts_stream():
    """Streaming endpoint: one NDJSON pcm line per sentence in order,
    ramped waves (first batch is a single sentence), pauses prepended to
    every chunk but the first, and a final done line with totals."""
    calls = []
    b = MicroBatcher(slow_infer(calls), max_batch=8, max_wait_ms=20)
    srv = make_server(b, port=0, sample_rate=22050)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        code, lines = _post_stream(
            port,
            {"text": "One here. Two here! Three here? Four here.",
             "pause_ms": 100},
        )
        assert code == 200
        gap = int(22050 * 0.1)
        body, done = lines[:-1], lines[-1]
        assert [l["i"] for l in body] == [0, 1, 2, 3]
        assert done["done"] and done["sentences"] == 4
        assert done["sample_rate"] == 22050 and done["rtf"] is not None
        # chunk 0: bare sentence; chunks 1..: gap + sentence
        pcm0 = np.frombuffer(base64.b64decode(body[0]["pcm"]), dtype="<i2")
        assert pcm0.shape == (100,) and body[0]["samples"] == 100
        pcm1 = np.frombuffer(base64.b64decode(body[1]["pcm"]), dtype="<i2")
        assert pcm1.shape == (100 + gap,)
        assert pcm1[:gap].max() == 0 and abs(pcm1[gap] / 32768 - 0.5) < 1e-3
        assert done["audio_seconds"] == round((4 * 100 + 3 * gap) / 22050, 3)
        # ramped waves: the first dispatched batch is exactly one sentence
        assert calls[0] == ["One here."]
        assert sum(len(c) for c in calls) == 4
        # the stream shares the /tts machinery: stats account for it
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as r:
            h = json.loads(r.read())
        assert h["sentences"] == 4
        # stream wall-clocks land in their own /healthz window (article
        # length must not pollute the single-shot /tts p95)
        assert h["stream_p50_ms"] > 0 and "latency_p50_ms" not in h

        # validation errors arrive as plain JSON with a 400
        assert _post_stream(port, {})[0] == 400
        assert _post_stream(port, {"text": "   "})[0] == 400
        assert _post_stream(port, {"text": "Hi.", "pause_ms": -1})[0] == 400
    finally:
        srv.shutdown()
        b.close()


def test_http_tts_stream_inband_error():
    """A synthesis failure after the 200 header is reported as a final
    in-band {"error": ...} line, not a hung connection."""
    def boom(texts):
        raise RuntimeError("graph exploded")

    b = MicroBatcher(boom, max_batch=4, max_wait_ms=10)
    srv = make_server(b, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        code, lines = _post_stream(port, {"text": "Boom now."}, timeout=60)
        assert code == 200
        assert "error" in lines[-1] and "graph exploded" in lines[-1]["error"]
    finally:
        srv.shutdown()
        b.close()


def test_healthz_latency_percentiles(server):
    """After served requests, /healthz reports rolling p50/p95 request
    latency (production observability; absent before any request)."""
    srv, _ = server
    port = srv.server_address[1]
    for _ in range(3):
        assert _post(port, {"texts": ["tick"]})[0] == 200
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    ) as r:
        h = json.loads(r.read())
    assert h["latency_p50_ms"] > 0
    assert h["latency_p95_ms"] >= h["latency_p50_ms"]
    assert "stream_p50_ms" not in h  # no /tts_stream requests were made


def test_percentile_nearest_rank():
    """p95 of a 20-sample window is the 19th order statistic, not the max
    (int(q·n) indexing would peg p95 to a single cold-compile outlier)."""
    from dex_tts_tpu_torch.serving import _percentile

    vals = sorted(range(1, 21))  # 1..20
    assert _percentile(vals, 0.95) == 19
    assert _percentile(vals, 0.50) == 10
    assert _percentile([7.0], 0.95) == 7.0


def test_microbatcher_bounded_queue_rejects_and_recovers():
    """At max_queue pending sentences submit() raises QueueFull (counted
    in .rejected); accepted work still completes once the device frees up
    — overload sheds load, it does not dangle futures."""
    from dex_tts_tpu_torch.serving import QueueFull

    gate = threading.Event()

    def infer(texts):
        gate.wait(10)
        return [{"wav": np.zeros(10, np.float32), "text": t} for t in texts]

    b = MicroBatcher(infer, max_batch=1, max_wait_ms=1, max_queue=2)
    try:
        first = b.submit("s0")  # worker takes this and blocks in infer
        deadline = time.monotonic() + 5
        while b.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        accepted = [first, b.submit("s1"), b.submit("s2")]  # fills the queue
        with pytest.raises(QueueFull):
            b.submit("s3")
        assert b.rejected == 1
        gate.set()
        outs = [f.result(timeout=10) for f in accepted]
        assert [o["text"] for o in outs] == ["s0", "s1", "s2"]
    finally:
        gate.set()
        b.close()


def test_submit_all_rolls_back_on_queue_full():
    """A multi-sentence request that trips the bound mid-loop cancels its
    already-admitted futures: a rejected request leaves zero orphaned
    sentences behind for the worker to synthesize."""
    from dex_tts_tpu_torch.serving import QueueFull, _submit_all

    gate = threading.Event()
    calls = []

    def infer(texts):
        calls.append(list(texts))
        gate.wait(10)
        return [{"wav": np.zeros(10, np.float32), "text": t} for t in texts]

    b = MicroBatcher(infer, max_batch=1, max_wait_ms=1, max_queue=2)
    try:
        hold = b.submit("hold")  # occupy the worker
        deadline = time.monotonic() + 5
        while b.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(QueueFull):
            _submit_all(b, ["a", "b", "c"])  # third sentence overflows
        gate.set()
        hold.result(timeout=10)
        probe = b.submit("probe")
        assert probe.result(timeout=10)["text"] == "probe"
    finally:
        gate.set()
        b.close()
    # the cancelled a/b never reached the device
    assert calls == [["hold"], ["probe"]]


def test_http_overload_503_with_retry_after():
    """More concurrent clients than queue capacity: extras get a fast 503
    with Retry-After, admitted clients still get 200 audio, /healthz shows
    the rejection; nothing dangles after the flood."""
    gate = threading.Event()

    def infer(texts):
        gate.wait(10)
        return [{"wav": np.full((50,), 0.5, np.float32), "text": t}
                for t in texts]

    b = MicroBatcher(infer, max_batch=1, max_wait_ms=1, max_queue=2)
    srv = make_server(b, port=0, sample_rate=22050)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    results = []

    def client(i):
        results.append(_post(port, {"texts": [f"s{i}"]}, timeout=30))

    try:
        # deterministic saturation: occupy the worker with a
        # directly-submitted sentence FIRST, so the flood does not depend
        # on the worker dequeuing client 1 before client 3 submits
        warm = b.submit("warm0")
        deadline = time.monotonic() + 5
        while (
            not (b.batch_sizes and b.queue_depth() == 0)
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        assert b.batch_sizes and b.queue_depth() == 0  # worker holds warm0
        clients = [
            threading.Thread(target=client, args=(i,)) for i in range(2)
        ]
        for c in clients:
            c.start()
        deadline = time.monotonic() + 5
        while b.queue_depth() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.queue_depth() >= 2
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts",
            data=json.dumps({"texts": ["overflow"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=10)
        err = exc_info.value
        assert err.code == 503
        assert err.headers["Retry-After"]
        body = json.loads(err.read())
        assert "queue full" in body["error"]

        code, health = _get_healthz(port)
        assert health["rejected"] >= 1
        assert health["max_queue"] == 2

        gate.set()
        assert warm.result(timeout=30)["text"] == "warm0"
        for c in clients:
            c.join(timeout=30)
        assert [code for code, _ in results] == [200, 200]
        # drained: queue empty again (sentinel-free steady state)
        deadline = time.monotonic() + 5
        while b.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.queue_depth() == 0
    finally:
        gate.set()
        srv.shutdown()
        b.close()


def _get_healthz(port):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    ) as r:
        return r.status, json.loads(r.read())


def test_microbatcher_urgent_jumps_backlog():
    """Urgent submissions (a stream's first wave — its
    time-to-first-audio) are served before older normal backlog."""
    import threading as th

    gate = th.Event()
    calls = []

    def infer(texts):
        calls.append(list(texts))
        gate.wait(timeout=10)  # hold the worker so a backlog builds
        return [{"wav": np.zeros(10, np.float32), "text": t} for t in texts]

    # same-length texts so the length-aware splitter cannot reorder —
    # this test isolates the admission priority
    b = MicroBatcher(infer, max_batch=2, max_wait_ms=5)
    try:
        first = b.submit("head00")  # occupies the worker
        time.sleep(0.1)
        normals = [b.submit(f"norm_{i}") for i in range(4)]
        urgent = b.submit("URGENT!", urgent=True)
        gate.set()  # release: next collected batch must contain URGENT!
        assert urgent.result(timeout=10)["text"] == "URGENT!"
        for f in [first] + normals:
            f.result(timeout=10)
    finally:
        b.close()
    # batch 1 = head alone; the urgent item rides the very next batch,
    # ahead of the 4 normals submitted before it
    assert "URGENT!" in calls[1], calls
    # and every normal item is still served (no starvation of the bulk)
    flat_after_head = [t for c in calls[1:] for t in c]
    assert {f"norm_{i}" for i in range(4)} <= set(flat_after_head)


# one arrival sequence: (text, urgent); mixed lengths exercise the
# length split, urgent entries the queue order
ARRIVALS = [("short one", False), ("a much longer sentence " * 3, False), ("first!", True),
            ("tiny", False), ("another long sentence here " * 3, False), ("go", True),
            ("mid length text", False), ("again a mid text", False), ("x", False),
            ("wave one", True), ("last of all the sentences " * 2, False)]


@pytest.mark.parametrize("max_batch", [1, 4, 16])
def test_microbatcher_batches_like_jax(max_batch):
    """Both batchers, fed the same arrivals behind a held worker, serve
    the same batches in the same order (the arrivals fall well inside the
    port's aging bound, where its order is the JAX package's)."""
    served = {}
    for name, cls in (("jax", JaxMicroBatcher), ("port", MicroBatcher)):
        gate = threading.Event()
        calls = []

        def infer(texts, calls=calls, gate=gate):
            calls.append(list(texts))
            gate.wait(10)
            return [{"text": t} for t in texts]

        b = cls(infer, max_batch=max_batch, max_wait_ms=20, max_queue=64)
        try:
            head = b.submit("head")
            deadline = time.monotonic() + 5
            while not calls and time.monotonic() < deadline:
                time.sleep(0.002)
            futs = [b.submit(text, urgent=urgent) for text, urgent in ARRIVALS]
            gate.set()
            for f in [head] + futs:
                f.result(timeout=10)
        finally:
            gate.set()
            b.close()
        served[name] = (list(b.batch_sizes), calls)
    assert served["port"] == served["jax"]
    assert served["port"][0][0] == 1  # the held head


def _starve(cls, duration_s, infer_s=0.02, max_wait_ms=5.0):
    """Keep ≥ 3 urgent first waves queued for ``duration_s`` while one
    continuation wave waits → (seconds from its submit to its dispatch,
    or None if it was not dispatched before the urgent arrivals stopped,
    seconds the arrivals ran)."""
    started = {}

    def infer(texts):
        for t in texts:
            started.setdefault(t, time.monotonic())
        time.sleep(infer_s)
        return [{"text": t} for t in texts]

    b = cls(infer, max_batch=1, max_wait_ms=max_wait_ms, split_length_ratio=0)
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            if b.queue_depth() < 4:
                b.submit(f"urgent {i}", urgent=True)
                i += 1
            time.sleep(0.001)

    feeder = threading.Thread(target=feed, daemon=True)
    try:
        feeder.start()
        time.sleep(0.1)  # the urgent backlog is there
        t_submit = time.monotonic()
        cont = b.submit("continuation wave")
        time.sleep(duration_s)
        t_stop = time.monotonic()
        stop.set()
        feeder.join(timeout=5)
        assert not feeder.is_alive()
        cont.result(timeout=10)
    finally:
        stop.set()
        b.close()
    waited = started["continuation wave"] - t_submit
    return (waited if started["continuation wave"] < t_stop else None), t_stop - t_submit


def test_continuation_wave_is_not_starved():
    """Under sustained urgent arrivals (a new first wave whenever fewer
    than three are queued, each batch 20 ms) the port serves a waiting
    continuation wave once it has aged past its bound (AGING_WAITS linger
    windows) and the urgent waves due before it are out; the JAX
    batcher, on the same arrivals, serves it only after they stop."""
    aging_s = AGING_WAITS * 5e-3
    waited, ran = _starve(MicroBatcher, duration_s=4 * aging_s)
    assert waited is not None, "the port starved the continuation wave"
    # its bound, then the ≤ 4 queued waves due before it and one in flight
    assert aging_s <= waited < aging_s + 0.5, waited
    jax_waited, jax_ran = _starve(JaxMicroBatcher, duration_s=4 * aging_s)
    assert jax_waited is None and jax_ran >= 4 * aging_s  # starved while arrivals ran


def test_synthesize_main_tiny(tiny_experiment, monkeypatch, tmp_path):
    """`python -m dex_tts_tpu_torch.synthesize` in-process on the CPU: one
    sentence and a 3-sentence paragraph (--long), 22.05 kHz int16 WAVs of
    the right length; the sentence equals a direct `tts` with a generator
    seeded as the CLI seeds it."""
    preset, exp_dir = tiny_experiment
    monkeypatch.setitem(PRESETS, "tiny_serve", lambda: preset)
    common = ["--preset", "tiny_serve", "--weight_path", exp_dir, "--n_timesteps", "2",
              "--device", "cpu", "--out_dir", str(tmp_path), "--seed", "7"]
    [(path, out)] = synthesize.main(common + ["--input_text", "Hello there."])
    assert path == os.path.join(str(tmp_path), "sample.wav")
    wav, sr = read_wav(path)
    assert sr == 22050 and wav.shape == out["wav"].shape == (out["n_frames"] * 256,)
    assert np.isfinite(out["wav"]).all()
    synth = load_synthesizer(preset, exp_dir, n_timesteps=2, device="cpu")
    direct = synth.tts(["Hello there."], generator=torch.Generator().manual_seed(7))[0]["wav"]
    np.testing.assert_allclose(out["wav"], direct, atol=1e-4 * np.abs(direct).max())
    np.testing.assert_allclose(wav, out["wav"], atol=1 / 32768)

    paragraph = "First one here. The second sentence! And a third?"
    [(path, out)] = synthesize.main(common + ["--input_text", paragraph, "--long",
                                              "--pause_ms", "100"])
    wav, sr = read_wav(path)
    gap = int(22050 * 0.1)
    assert wav.shape == out["wav"].shape == (out["n_frames"] * 256 + 2 * gap,)
    assert np.isfinite(wav).all()


def test_serve_wiring_tiny(tiny_experiment, monkeypatch):
    """`dex_tts_tpu_torch.serve.build_server` as the CLI calls it: loads
    through load_synthesizer, warms up on the calling thread, serves /tts
    and /tts_stream; /healthz names the device; one generator advances
    across batches (the same text twice gets different noise)."""
    preset, exp_dir = tiny_experiment
    monkeypatch.setitem(PRESETS, "tiny_serve", lambda: preset)
    args = serve.parse_args(["--preset", "tiny_serve", "--weight_path", exp_dir,
                             "--n_timesteps", "2", "--device", "cpu", "--port", "0",
                             "--max_batch", "4", "--warmup", "Warm up."])
    srv, b = serve.build_server(args)
    assert b.batch_sizes == []  # the warm-up ran before the batcher
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        wavs = []
        for _ in range(2):
            code, out = _post(port, {"texts": ["Same words again."]}, timeout=300)
            assert code == 200
            wavs.append(np.frombuffer(base64.b64decode(out["wavs"][0]), dtype="<i2"))
        assert wavs[0].shape == wavs[1].shape and not np.array_equal(wavs[0], wavs[1])
        code, lines = _post_stream(port, {"text": "One here. Two here. Three here."},
                                   timeout=300)
        assert code == 200 and [line.get("i") for line in lines[:-1]] == [0, 1, 2]
        assert lines[-1]["done"]
        _, h = _get_healthz(port)
        assert h["device"] == "cpu" and h["card"] is None and h["n_timesteps"] == 2
        assert h["sentences"] == 5 and b.batch_sizes[0] == 1
    finally:
        srv.shutdown()
        b.close()
        srv.server_close()
