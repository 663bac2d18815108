"""The port's streaming plane (K9, ``gordo_tpu_torch/serve/stream.py``).

- unit: the event ring, subscriber fan-out, SSE framing, the long poll and
  the env knobs, as ``tests/test_stream.py:55-165`` pins the JAX package's
  (the port's queues are ``queue.Queue``: its server is threaded);
- numerical: every steady-state f32 verdict of the port's stream is bit
  for bit its own request path over the same trailing rows
  (``reference_verdict``: ``fleet_score``, after ``lstm_layer`` for an
  LSTM, then ``rolling_median``), for feedforward detectors with and
  without a window, LSTM ``ae`` and ``forecast``, across a generation flip
  and a geometry re-prime, as ``tests/test_stream.py:181-300`` pins the
  JAX package's; and the port's verdicts are within 1e-5 (the serving
  parity bound, max |ref - port| / max |ref| per series) of the JAX
  package's ``MachineStream`` on the same converted weights (measured on
  the CPU: at most 2.9e-7 over every series);
- integration: the HTTP routes (``POST {p}/stream/ingest``, ``GET
  {p}/stream`` as SSE and as ``?mode=poll``) and their 400, 404 and 422
  answers.

JAX models are ``module.init`` params with MinMax stats fitted by hand
(``tests/torch_parity.py::init_detector``), carried across with
``gordo_tpu_torch.convert``; the port runs on the CPU (plain versions).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.models.estimator import LSTMForecast as JaxLSTMForecast
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.serve.stream import MachineStream as JaxMachineStream
from gordo_tpu_torch import serializer
from gordo_tpu_torch.kernels import stream_step as sk
from gordo_tpu_torch.serve import stream as stream_mod
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from gordo_tpu_torch.serve.stream import (
    EventRing,
    MachineStream,
    StreamHub,
    StreamUnsupported,
    reference_verdict,
    sse_format,
)
from torch_parity import carry, init_detector, r12

TAGS = 3
TOL = 1e-5
PROJECT = "stream"


# -- unit: ring / subscribers / framing ----------------------------------------

class TestEventRing:
    def test_monotonic_ids_and_since(self):
        ring = EventRing(maxlen=16)
        for i in range(5):
            ring.append("verdict", {"machine": "m", "n": i})
        assert ring.last_id == 5
        events, gap = ring.since(2)
        assert [e["id"] for e in events] == [3, 4, 5]
        assert not gap

    def test_machine_filter(self):
        ring = EventRing(maxlen=16)
        ring.append("verdict", {"machine": "a"})
        ring.append("verdict", {"machine": "b"})
        events, _ = ring.since(0, machines={"b"})
        assert [e["data"]["machine"] for e in events] == ["b"]

    def test_replay_gap_when_trimmed(self):
        ring = EventRing(maxlen=4)
        for i in range(10):
            ring.append("verdict", {"n": i})
        events, gap = ring.since(2)
        assert gap
        assert [e["id"] for e in events] == [7, 8, 9, 10]
        _, gap = ring.since(10)
        assert not gap

    def test_fresh_ring_no_gap(self):
        _, gap = EventRing(maxlen=4).since(0)
        assert not gap


class TestHubFanout:
    def test_publish_fans_to_matching_subscribers(self):
        hub = StreamHub()
        all_sub = hub.subscribe()
        only_b = hub.subscribe(["b"])
        hub.publish("verdict", {"machine": "a"})
        hub.publish("verdict", {"machine": "b"})
        assert all_sub.queue.qsize() == 2
        assert only_b.queue.qsize() == 1
        assert only_b.queue.get_nowait()["data"]["machine"] == "b"
        hub.unsubscribe(all_sub)
        hub.unsubscribe(only_b)
        assert hub.n_subscribers == 0

    def test_slow_consumer_marked_dead_on_overflow(self):
        hub = StreamHub()
        sub = hub.subscribe(maxsize=2)
        for i in range(4):
            hub.publish("verdict", {"machine": "m", "n": i})
        assert sub.dead
        events, gap = hub.ring.since(0)
        assert len(events) == 4 and not gap

    def test_dead_subscriber_skipped(self):
        hub = StreamHub()
        sub = hub.subscribe()
        sub.dead = True
        hub.publish("verdict", {"machine": "m"})
        assert sub.queue.qsize() == 0

    def test_close_wakes_and_kills_subscribers(self):
        hub = StreamHub()
        sub = hub.subscribe()
        hub.close()
        assert sub.dead and sub.queue.get_nowait() is None


class TestSseFraming:
    def test_frame_layout(self):
        frame = sse_format({"id": 7, "type": "verdict", "data": {"machine": "m"}})
        assert frame == b'id: 7\nevent: verdict\ndata: {"machine":"m"}\n\n'

    def test_poll_events_returns_batch_and_cursor(self):
        hub = StreamHub()
        hub.publish("verdict", {"machine": "m", "n": 0})
        doc = stream_mod.poll_events(hub, None, 0, timeout=0)
        assert doc["last-event-id"] == 1
        assert len(doc["events"]) == 1 and not doc["replay-gap"]

    def test_poll_waits_for_next_event(self):
        hub = StreamHub()

        def later():
            time.sleep(0.05)
            hub.publish("verdict", {"machine": "m"})

        thread = threading.Thread(target=later)
        thread.start()
        doc = stream_mod.poll_events(hub, None, 0, timeout=5.0)
        thread.join()
        assert len(doc["events"]) == 1 and hub.n_subscribers == 0

    def test_run_sse_replays_then_tails(self):
        hub = StreamHub()
        for i in range(3):
            hub.publish("verdict", {"machine": "m", "n": i})
        sub = hub.subscribe()
        frames = []

        def write(frame):
            frames.append(frame)
            if len(frames) == 3:  # the two replayed, then one live
                sub.dead = True

        thread = threading.Thread(target=stream_mod.run_sse, args=(write, hub, sub, 1))
        thread.start()
        time.sleep(0.05)
        hub.publish("verdict", {"machine": "m", "n": 3})
        thread.join(timeout=5)
        assert [int(f.split(b"\n")[0][4:]) for f in frames] == [2, 3, 4]
        assert hub.n_subscribers == 0


def test_concurrent_publishers_and_ingests_lose_nothing(models):
    """Handler threads publish and ingest at once: every event gets its
    own id, in order, and every row of a machine is applied exactly once."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        hub = StreamHub(ring_size=10_000)
        sub = hub.subscribe(maxsize=10_000)

        def publish():
            for _ in range(200):
                hub.publish("verdict", {"machine": "m"})

        threads = [threading.Thread(target=publish) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        events, _ = hub.ring.since(0)
        assert [e["id"] for e in events] == list(range(1, 3201))
        queued = [sub.queue.get_nowait()["id"] for _ in range(3200)]
        assert queued == sorted(queued) and len(set(queued)) == 3200

        scorer = CompiledScorer(models["port"]["ff-unsmoothed"], device="cpu")
        rows = models["rows"][:40]
        threads = [threading.Thread(target=hub.ingest_rows, args=("m", scorer, rows[5 * i: 5 * i + 5]))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert hub.streams["m"].count == 40
        steps = sorted(e["data"]["step"] for e in hub.ring.since(3200)[0] if e["type"] == "verdict")
        assert steps == list(range(1, 41))
    finally:
        sys.setswitchinterval(interval)


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("GORDO_STREAM_REPLAY", "128")
    monkeypatch.setenv("GORDO_STREAM_QUEUE", "9")
    monkeypatch.setenv("GORDO_STREAM_KEEPALIVE", "3.5")
    monkeypatch.setenv("GORDO_STREAM_POLL_TIMEOUT", "1.5")
    assert stream_mod.replay_ring_size() == 128
    assert stream_mod.queue_depth() == 9
    assert stream_mod.keepalive_seconds() == 3.5
    assert stream_mod.poll_timeout_seconds() == 1.5
    assert EventRing()._events.maxlen == 128
    assert stream_mod.Subscriber().queue.maxsize == 9


# -- numerical parity ------------------------------------------------------------

KINDS = {
    "ff-smoothed": (lambda: JaxAutoEncoder(kind="feedforward_hourglass"), 5),
    "ff-unsmoothed": (lambda: JaxAutoEncoder(kind="feedforward_hourglass"), None),
    "lstm-ae": (lambda: JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=4), 5),
    "lstm-forecast": (lambda: JaxLSTMForecast(kind="lstm_hourglass", lookback_window=4), 3),
}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((200, TAGS)).astype(np.float32)
    jax_models = {name: init_detector(make(), X, rng, window=window, seed=i)
                  for i, (name, (make, window)) in enumerate(KINDS.items())}
    # a second generation of the smoothed detector, and one with another window
    jax_models["ff-smoothed-b"] = init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng,
                                                window=5, seed=11)
    jax_models["ff-window-7"] = init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng,
                                              window=7, seed=12)
    jax_models["ff-window-3"] = init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng,
                                              window=3, seed=13)
    rows = (np.sin(0.2 * np.arange(60))[:, None] + 0.3 * rng.standard_normal((60, TAGS))).astype(np.float32)
    return {"jax": jax_models, "port": {k: carry(m) for k, m in jax_models.items()}, "rows": rows}


def _assert_bitwise(verdict, ref):
    assert set(verdict) == set(ref)
    for k in ref:
        assert np.asarray(verdict[k], np.float32).tobytes() == np.asarray(ref[k], np.float32).tobytes(), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_stream_is_its_request_path_bit_for_bit(models, kind):
    scorer = CompiledScorer(models["port"][kind], device="cpu")
    ms = MachineStream("parity", scorer)
    X = models["rows"]
    checked = 0
    for t in range(1, len(X) + 1):
        verdict = ms.ingest(X[t - 1])
        if t <= ms.offset:
            assert verdict is None
            continue
        assert verdict is not None
        for k, v in verdict.items():
            assert np.asarray(v).dtype == np.float32, k
        if t >= ms.state_rows:
            _assert_bitwise(verdict, reference_verdict(scorer, X[t - ms.state_rows:t]))
            checked += 1
    assert checked >= 40 and ms.count == len(X)


@pytest.mark.parametrize("kind", list(KINDS))
def test_stream_matches_jax_machine_stream(models, kind):
    jax_ms = JaxMachineStream("parity", JaxScorer(models["jax"][kind]))
    ms = MachineStream("parity", CompiledScorer(models["port"][kind], device="cpu"))
    assert (ms.offset, ms.state_rows) == (jax_ms.offset, jax_ms.state_rows)
    refs, gots = [], []
    for row in models["rows"]:
        ref, got = jax_ms.ingest(row), ms.ingest(row)
        assert (ref is None) == (got is None)
        if ref is not None:
            refs.append(ref)
            gots.append(got)
    for k in refs[0]:
        ref = np.stack([np.atleast_1d(r[k]) for r in refs])
        got = np.stack([np.atleast_1d(g[k]) for g in gots])
        assert r12(ref, got) <= TOL, (k, r12(ref, got))


def test_generation_flip_keeps_the_ring(models):
    """A model swap with the same window geometry keeps the ring; the first
    verdict after it is the new model's request path bit for bit."""
    scorer_a = CompiledScorer(models["port"]["ff-smoothed"], device="cpu")
    scorer_b = CompiledScorer(models["port"]["ff-smoothed-b"], device="cpu")
    hub = StreamHub()
    X = models["rows"]
    ms = None
    for t in range(1, len(X) + 1):
        scorer = scorer_a if t <= 20 else scorer_b
        ms = hub.stream_for("flip", scorer)
        verdict = ms.ingest(X[t - 1])
        if t >= ms.state_rows:
            _assert_bitwise(verdict, reference_verdict(scorer, X[t - ms.state_rows:t]))
    assert ms.scorer is scorer_b and ms.count == len(X)


def test_geometry_change_reprimes_from_the_mirror(models):
    scorer_a = CompiledScorer(models["port"]["ff-window-7"], device="cpu")
    scorer_b = CompiledScorer(models["port"]["ff-window-3"], device="cpu")
    X = models["rows"][:30]
    ms = MachineStream("geom", scorer_a)
    for t in range(1, 16):
        ms.ingest(X[t - 1])
    ms.rebind(scorer_b)  # 7-row ring -> 3-row ring, re-primed from the mirror
    assert ms.state_rows == 3
    for t in range(16, len(X) + 1):
        _assert_bitwise(ms.ingest(X[t - 1]), reference_verdict(scorer_b, X[t - ms.state_rows:t]))


def test_rebind_to_another_precision_keeps_the_rows(models):
    scorer = CompiledScorer(models["port"]["ff-smoothed"], device="cpu")
    X = models["rows"]
    ms = MachineStream("prec", scorer)
    for row in X[:10]:
        ms.ingest(row)
    ms.rebind(CompiledScorer(models["port"]["ff-smoothed"], device="cpu", dtype="bfloat16"))
    assert ms.dtype == "bfloat16" and ms._rings[0].dtype.is_floating_point
    got = ms.ingest(X[10])
    ref = reference_verdict(ms.scorer, X[6:11])
    _assert_bitwise(got, ref)


def test_stream_step_plain_masks_the_warm_up(models):
    """Before the ring is full the older raw scores are masked: the verdict
    is the nanmedian of the newest ``count - offset`` raw scores."""
    raw = np.arange(10, dtype=np.float32).reshape(5, 2)
    import torch

    for n_valid, want in ((5, [4.0, 5.0]), (2, [7.0, 8.0]), (1, [8.0, 9.0]), (0, [np.nan, np.nan])):
        got = sk.masked_nanmedian(torch.from_numpy(raw), n_valid).numpy()
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_models_without_a_detector_or_thresholds_cannot_stream(models):
    pipe = models["port"]["ff-smoothed"].base_estimator
    with pytest.raises(StreamUnsupported, match="detector"):
        MachineStream("pipe", CompiledScorer(pipe, device="cpu"))
    det = models["port"]["ff-smoothed"].clone()
    det.load_state_arrays(models["port"]["ff-smoothed"].state_arrays())
    det.feature_thresholds_ = det.aggregate_threshold_ = None
    with pytest.raises(StreamUnsupported, match="thresholds"):
        MachineStream("bare", CompiledScorer(det, device="cpu"))


def test_windows_the_step_cannot_hold_are_refused_when_the_stream_binds():
    """A 128-tag hourglass with a 500-row window is served by the request
    path but its W x 129 raw scores do not fit ``stream_step``'s block:
    the stream refuses it at bind (a 422 at the route), not mid-ingest."""
    from gordo_tpu_torch import convert

    rng = np.random.default_rng(2)
    dims = [128, 107, 85, 64, 64, 85, 107, 128]
    names = [f"dense_{i}" for i in range(len(dims) - 2)] + ["out"]
    params = {n: {"kernel": rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i]),
                  "bias": np.zeros(dims[i + 1])} for i, n in enumerate(names)}
    stats = {"scale": np.ones(128), "offset": np.zeros(128)}
    definition = {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "window": 500,
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            "gordo_tpu.ops.scalers.MinMaxScaler",
            {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
        ]}}}}
    model = convert.from_reference(definition, params, scaler_stats=[stats], detector_stats=stats,
                                   feature_thresholds=np.ones(128), aggregate_threshold=1.0)
    scorer = CompiledScorer(model, device="cpu")
    assert scorer.anomaly_arrays(np.zeros((4, 128), np.float32))["total-anomaly-score"].shape == (4,)
    with pytest.raises(StreamUnsupported, match="item 15"):
        MachineStream("wide", scorer)


# -- integration: the HTTP routes ----------------------------------------------

@pytest.fixture(scope="module")
def server(models, tmp_path_factory):
    out = tmp_path_factory.mktemp("port-stream-models")
    for name in ("ff-smoothed", "lstm-ae"):
        meta = {"dataset": {"tag_list": [f"tag-{j}" for j in range(TAGS)]}}
        serializer.dump(models["port"][name], str(out / name), metadata=meta)
    bare = models["port"]["ff-unsmoothed"].clone()
    bare.load_state_arrays(models["port"]["ff-unsmoothed"].state_arrays())
    bare.feature_thresholds_ = bare.aggregate_threshold_ = None
    serializer.dump(bare, str(out / "no-thresholds"))
    collection = ModelCollection.from_directory(str(out), project=PROJECT, device="cpu")
    srv = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield {"base": f"http://127.0.0.1:{srv.server_address[1]}/gordo/v0/{PROJECT}",
           "collection": collection}
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def call(url, payload=None, headers=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        try:
            return exc.code, json.loads(body)
        except ValueError:
            return exc.code, body


def test_ingest_both_body_forms_and_poll(server, models):
    base, hub = server["base"], server["collection"].stream_hub
    X = models["rows"]
    head = hub.ring.last_id
    status, doc = call(f"{base}/stream/ingest", {"machine": "ff-smoothed", "x": X[:3].tolist()})
    assert status == 200 and doc["accepted"] == 3 and doc["events"] >= 3
    assert doc["last-event-id"] == hub.ring.last_id
    status, doc = call(f"{base}/stream/ingest", {"X": {"ff-smoothed": X[3:5].tolist(), "lstm-ae": X[:5].tolist()}})
    assert status == 200 and doc["accepted"] == 7
    # the LSTM's first lookback - 1 rows give no verdict
    status, doc = call(f"{base}/stream?mode=poll&after={head}&timeout=0")
    assert status == 200
    verdicts = [e for e in doc["events"] if e["type"] == "verdict"]
    assert [e["data"]["machine"] for e in verdicts].count("ff-smoothed") == 5
    assert [e["data"]["machine"] for e in verdicts].count("lstm-ae") == 5 - 3
    ids = [e["id"] for e in doc["events"]]
    assert ids == sorted(ids) == list(range(head + 1, hub.ring.last_id + 1))
    assert doc["last-event-id"] == hub.ring.last_id and not doc["replay-gap"]
    status, doc = call(f"{base}/stream?mode=poll&after={head}&timeout=0&machines=lstm-ae")
    assert {e["data"]["machine"] for e in doc["events"]} == {"lstm-ae"}
    # the streamed verdict of the last row is the request path's
    ms = hub.streams["ff-smoothed"]
    ref = reference_verdict(ms.scorer, X[5 - ms.state_rows:5])
    last = [e for e in verdicts if e["data"]["machine"] == "ff-smoothed"][-1]["data"]
    assert np.float32(last["total-anomaly-score"]) == ref["total-anomaly-score"]


def test_sse_replays_from_last_event_id(server, models):
    base, hub = server["base"], server["collection"].stream_hub
    call(f"{base}/stream/ingest", {"machine": "ff-smoothed", "x": models["rows"][10:12].tolist()})
    after = hub.ring.last_id - 2
    req = urllib.request.Request(f"{base}/stream", headers={"Last-Event-ID": str(after)})
    frames = []
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        frame = {}
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("id: "):
                frame["id"] = int(line[4:])
            elif line.startswith("data: "):
                frame["data"] = json.loads(line[6:])
            elif line == "" and frame:
                frames.append(frame)
                frame = {}
                if frames[-1]["id"] == after + 2:
                    break
    assert [f["id"] for f in frames] == [after + 1, after + 2]
    deadline = time.time() + 10
    while hub.n_subscribers and time.time() < deadline:
        hub.publish("verdict", {"machine": "nobody"})  # the writer notices the closed peer
        time.sleep(0.05)
    assert hub.n_subscribers == 0


@pytest.mark.parametrize("case,status", [
    ("not json", 400), ("not an object", 400), ("no machine", 400), ("bad width", 400),
    ("unknown machine", 404), ("unknown in bulk", 404), ("no thresholds", 422),
    ("bad event id", 400), ("bad last-event-id", 400), ("unknown subscription", 404),
])
def test_error_answers(server, case, status):
    base = server["base"]
    row = [[0.1, 0.2, 0.3]]
    got = {
        "not json": lambda: call(f"{base}/stream/ingest", raw=b"{nope"),
        "not an object": lambda: call(f"{base}/stream/ingest", [1, 2]),
        "no machine": lambda: call(f"{base}/stream/ingest", {"x": row}),
        "bad width": lambda: call(f"{base}/stream/ingest", {"machine": "ff-smoothed", "x": [[0.1, 0.2]]}),
        "unknown machine": lambda: call(f"{base}/stream/ingest", {"machine": "nope", "x": row}),
        "unknown in bulk": lambda: call(f"{base}/stream/ingest", {"X": {"ff-smoothed": row, "nope": row}}),
        "no thresholds": lambda: call(f"{base}/stream/ingest", {"machine": "no-thresholds", "x": row}),
        "bad event id": lambda: call(f"{base}/stream?mode=poll&after=x&timeout=0"),
        "bad last-event-id": lambda: call(f"{base}/stream?mode=poll&timeout=0", headers={"Last-Event-ID": "q"}),
        "unknown subscription": lambda: call(f"{base}/stream?mode=poll&machines=ff-smoothed,nope&timeout=0"),
    }[case]()
    assert got[0] == status, got
    if status == 422:
        assert "thresholds" in got[1]["error"]
    if case == "unknown in bulk":
        # nothing of the request was applied
        assert "nope" in got[1]
