"""Streaming scoring plane: push-based online anomaly detection.

Counterpart of ``gordo_tpu/serve/stream.py``: sensor rows arrive one at a
time and verdicts are pushed to subscribers.

* **The step** (``kernels/stream_step.py``).  The carried state is a raw
  input ring of ``H = offset + W`` rows (W = max(detector window, 1)) and
  the count of rows ever ingested, resident on the card as a double
  buffer, beside the tag scores of the W scored rows (W x fo float32,
  double-buffered too).  One arriving row of a feedforward chain is ONE
  ``stream_step`` launch (ring shift, scaler, dense stack over the newest
  row, detector scores, the carried tags shifted, every row's total,
  masked nanmedian, confidence).  An LSTM chain (``ae``, ``forecast``)
  shifts the ring first (``stream_shift``), runs one ``lstm_layer`` per
  layer over the ring's newest window, then scores with ``stream_step``
  (its ``out`` head).  A fused transform chain (``SimpleImputer``,
  ``PCA`` and scaler steps, the JAX package's
  ``gordo_tpu/serve/stream.py:227-228``) takes the same route: the shift,
  one ``chain_apply`` over the shifted ring's newest row (window), the
  LSTM layers if any, then ``stream_step`` with the chain's (or the last
  layer's) output as the dense stack's input, scored against the raw
  ring rows.  The first step after the stream binds or rebinds (a
  generation flip, another precision, a geometry re-prime) scores all W
  rows (windows) and primes the carried tags; the kernels compute a row
  or window by the same instructions whichever launch holds it, so both
  modes give the same bits.  On the CPU the plain versions' matrix
  products pick their kernel by the number of rows, so there every step
  runs the chain and the LSTM over the whole ring and keeps the newest
  row.  At steady state (``count >= H``) the verdict is bit for bit the
  port's request path over the same H trailing rows
  (:func:`reference_verdict`).  The ring is stored at the serving
  precision's storage dtype.

* **Per-machine state** (:class:`MachineStream`): the device ring, the
  count, the carried tag scores and a host mirror of the raw rows.
  ``rebind`` after a model swap keeps the ring when the window geometry
  is unchanged (the first verdict after it is already the new model's
  exact one) and re-primes a fresh ring from the mirror when it changed.

* **The hub** (:class:`StreamHub`): a monotonic event log with a bounded
  replay ring, fan-out to per-subscriber bounded queues, SSE framing and
  the long poll.  The port's server is a ``ThreadingHTTPServer``, so
  subscriber queues are ``queue.Queue`` and waits block their own thread.

Event types: ``verdict`` (per valid row) and ``threshold`` (crossings of
the aggregate threshold, transitions only).  Env knobs as the JAX
package's: ``GORDO_STREAM_REPLAY`` (4096), ``GORDO_STREAM_QUEUE`` (256),
``GORDO_STREAM_KEEPALIVE`` (15 s), ``GORDO_STREAM_POLL_TIMEOUT`` (25 s).

Not in the port yet: ``drift`` events, which read the fleet-health
sketches (ROADMAP queue 1 item 10: ``_emit`` publishes none); the
``stream.ingest`` and ``stream.push`` fault seams (item 12); the stream's
telemetry counters and the verdict's fold into the health sketches (items
9 and 10).  ``warm_stream_program`` has no counterpart: the port compiles
nothing per shape.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from gordo_tpu_torch.kernels.chain_apply import chain_apply
from gordo_tpu_torch.kernels.lstm_layer import lstm_layer
from gordo_tpu_torch.kernels.stream_step import launch_plan, stream_shift, stream_step
from gordo_tpu_torch.serve import precision

__all__ = [
    "MachineStream",
    "StreamHub",
    "Subscriber",
    "EventRing",
    "StreamUnsupported",
    "reference_verdict",
    "sse_format",
    "run_sse",
    "poll_events",
    "replay_ring_size",
    "queue_depth",
    "keepalive_seconds",
    "poll_timeout_seconds",
]


def replay_ring_size() -> int:
    """``GORDO_STREAM_REPLAY``: events the hub retains for by-id resume."""
    return int(os.environ.get("GORDO_STREAM_REPLAY", "4096"))


def queue_depth() -> int:
    """``GORDO_STREAM_QUEUE``: per-subscriber queue bound; overflow
    disconnects the subscriber (it resumes by Last-Event-ID)."""
    return int(os.environ.get("GORDO_STREAM_QUEUE", "256"))


def keepalive_seconds() -> float:
    """``GORDO_STREAM_KEEPALIVE``: SSE comment interval on idle connections."""
    return float(os.environ.get("GORDO_STREAM_KEEPALIVE", "15"))


def poll_timeout_seconds() -> float:
    """``GORDO_STREAM_POLL_TIMEOUT``: long-poll max wait."""
    return float(os.environ.get("GORDO_STREAM_POLL_TIMEOUT", "25"))


class StreamUnsupported(ValueError):
    """Model cannot serve the streaming plane (it needs a fused detector
    chain with thresholds, or one that does not require them, whose window
    of raw scores fits ``stream_step``'s block)."""


def _mode_offset(mode: str, lookback: int) -> int:
    """Rows consumed before the first output row (the request path's
    ``n - n_out``)."""
    if mode == "ae":
        return lookback - 1
    if mode == "forecast":
        return lookback
    return 0


def reference_verdict(scorer, rows: np.ndarray) -> Dict[str, np.ndarray]:
    """The parity oracle: the scorer's request path (``fleet_score``, after
    ``lstm_layer`` for an LSTM, then ``rolling_median`` with a window) over
    ``rows`` at their exact shape, returning the newest row's verdict
    arrays."""
    c = scorer.chain
    out = scorer._stack.score(np.ascontiguousarray(rows, np.float32)[None], with_anomaly=True)
    verdict = {
        "tag-anomaly-scores": out["tag-anomaly-scores"][0][-1],
        "total-anomaly-score": out["total-anomaly-score"][0][-1],
    }
    if c["detector"]["feature_thresholds"] is not None:
        verdict["anomaly-confidence"] = out["anomaly-confidence"][0][-1]
    return verdict


class MachineStream:
    """One machine's streaming session: device ring + host row mirror.

    The carried state is the raw-input ring and the count, independent of
    the model, so ``rebind(scorer)`` after a model swap keeps the session.
    """

    def __init__(self, name: str, scorer, dtype: Optional[str] = None):
        self.name = name
        self.count = 0
        self.exceeding = False
        self._rings: Optional[List[torch.Tensor]] = None
        self._tags: Optional[List[torch.Tensor]] = None
        self._primed = False
        self._cur = 0
        self._count_dev: Optional[torch.Tensor] = None
        self._rows: "collections.deque[np.ndarray]" = collections.deque()
        self._scorer = None
        self.state_rows = 0
        self.rebind(scorer, dtype)

    def rebind(self, scorer, dtype: Optional[str] = None) -> None:
        """(Re)attach to ``scorer``, carrying the session state across."""
        from gordo_tpu_torch.serve.scorer import _Stack

        c = getattr(scorer, "chain", None)
        if not c or not c.get("detector"):
            raise StreamUnsupported(
                f"machine {self.name!r} has no anomaly detector chain; the "
                "streaming plane needs a diff-based detector"
            )
        if not c["fused"]:
            raise StreamUnsupported(
                f"machine {self.name!r} has no fused anomaly chain; the streaming plane "
                "needs pure-stats transforms (no QuantileTransformer or FunctionTransformer "
                "step), a served estimator, and a diff-based detector"
            )
        det = c["detector"]
        if det["feature_thresholds"] is None and det["require_thresholds"]:
            raise StreamUnsupported(
                f"machine {self.name!r} requires thresholds but "
                "cross_validate() never derived them"
            )
        prior_rows = self.state_rows
        self._primed = False  # the next step scores every row and primes the carried tags
        self._scorer = scorer
        self.chain = c
        self.dtype = precision.canonical(dtype) if dtype else scorer.dtype
        self._stack = (scorer._stack if self.dtype == scorer.dtype
                       else _Stack([c], scorer.device, self.dtype))
        self.device = scorer.device
        self.offset = _mode_offset(c["mode"], c["lookback"])
        self.window = max(int(det["window"] or 0), 1)
        self.state_rows = self.offset + self.window
        self.with_confidence = det["feature_thresholds"] is not None
        dims = [int(self._stack.layers[0][0].shape[1])] + [int(W.shape[2]) for W, _ in self._stack.layers]
        try:
            launch_plan(dims, self.window)
        except ValueError as exc:
            raise StreamUnsupported(
                f"machine {self.name!r}: {exc}; long windows of wide chains wait "
                "for ROADMAP queue 1 item 15"
            ) from None
        self._store = precision.storage_dtype(self.dtype) or torch.float32
        if self.state_rows != prior_rows:
            # window geometry changed: re-prime a fresh ring from the host
            # mirror, the device count capped at the mirrored depth so the
            # mask treats unfillable older rows as warm-up (self.count
            # keeps the true position for event numbering)
            mirror = list(self._rows)[-self.state_rows:]
            self._rows = collections.deque(mirror, maxlen=self.state_rows)
            self._rings = None
            if mirror:
                ring = np.zeros((self.state_rows, mirror[0].shape[0]), np.float32)
                ring[self.state_rows - len(mirror):] = np.stack(mirror)
                self._init_state(ring, min(self.count, len(mirror)))
        elif self._rings is not None and self._rings[0].dtype != self._store:
            # same geometry, another precision: the ring at the new storage type
            self._rings = [r.to(self._store) for r in self._rings]

    @property
    def scorer(self):
        return self._scorer

    def _init_state(self, ring: np.ndarray, count: int) -> None:
        first = precision.cast_input(torch.from_numpy(ring), self.dtype).to(self.device)
        self._rings = [first, torch.empty_like(first)]
        fo = int(self._stack.layers[-1][0].shape[2])
        self._tags = [torch.empty((self.window, fo), dtype=torch.float32, device=self.device)
                      for _ in range(2)]
        self._primed = False
        self._cur = 0
        self._count_dev = torch.tensor([count], dtype=torch.int32).to(self.device)

    def _advance(self, x: np.ndarray) -> torch.Tensor:
        """One step on the device: the row's verdict (fo + 3,) float32."""
        st = self._stack
        ring_in, ring_out = self._rings[self._cur], self._rings[1 - self._cur]
        tags_in = self._tags[self._cur] if self._primed else None
        tags_out = self._tags[1 - self._cur]
        # the newest row (window) alone once the tags are primed; the plain
        # versions on the CPU take the whole ring (see the module's doc)
        newest = self._primed and self.device.type == "cuda"
        row = precision.cast_input(torch.from_numpy(x), self.dtype).to(self.device)
        kw = dict(window=self.window, mode_offset=self.offset, det=st.det, agg_thr=st.agg_thr,
                  tags_in=tags_in, tags_out=tags_out)
        with torch.no_grad():
            if st.mode == "none" and not st.transform_steps:
                verdict = stream_step(ring_in, self._count_dev, st.layers, st.acts,
                                      chain=st.scalers, x=row,
                                      ring_out=ring_out, **kw)
            else:
                stream_shift(ring_in, ring_out, self._count_dev, row)
                # window t is ring rows t .. t + lookback - 1, t < W (a
                # feedforward chain's lookback is 1)
                h = ring_out[None, self.window - 1: self.window - 1 + st.lookback] if newest else ring_out[None]
                n_windows = 1 if newest else self.window
                if st.transform_steps:
                    # the chain over those rows, out at the type the next
                    # kernel reads, as the request path's
                    h = chain_apply(h, st.transform_steps,
                                    out_dtype=torch.float32 if st.mode == "none" else h.dtype)
                for i, ((ki, kh, b), act) in enumerate(zip(st.cells, st.cell_acts)):
                    first = i == 0
                    h = lstm_layer(
                        h, ki, kh, b, lookback=st.lookback, act=act,
                        n_windows=n_windows if first else None,
                        chain=st.scalers if first else None,
                        last=i == len(st.cells) - 1,
                    )
                verdict = stream_step(ring_out, self._count_dev, st.layers, st.acts,
                                      h=h[0], **kw)
        self._cur = 1 - self._cur
        self._primed = True
        return verdict

    def ingest(self, x: np.ndarray) -> Optional[Dict[str, Any]]:
        """Score one arriving row; returns the verdict arrays (float32) of
        a valid (post-warm-up) row, else None."""
        x = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
        if self._rings is None:
            self._init_state(np.zeros((self.state_rows, x.shape[0]), np.float32), self.count)
        self._rows.append(x)
        out = self._advance(x).cpu().numpy()
        self.count += 1
        fo = out.shape[0] - 3
        if not out[fo + 2]:
            return None
        verdict = {
            "tag-anomaly-scores": out[:fo],
            "total-anomaly-score": out[fo],
        }
        if self.with_confidence:
            verdict["anomaly-confidence"] = out[fo + 1]
        return verdict


class EventRing:
    """Bounded in-memory event log with hub-global monotonic ids."""

    def __init__(self, maxlen: Optional[int] = None):
        self._events: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=maxlen or replay_ring_size()
        )
        self.last_id = 0

    def append(self, etype: str, data: Dict[str, Any]) -> Dict[str, Any]:
        self.last_id += 1
        ev = {"id": self.last_id, "type": etype, "data": data}
        self._events.append(ev)
        return ev

    def since(self, after: int, machines: Optional[Set[str]] = None) -> Tuple[List[Dict[str, Any]], bool]:
        """Events with id > ``after`` (filtered), and a gap flag: True when
        ids between ``after`` and the oldest retained event were trimmed."""
        oldest = self._events[0]["id"] if self._events else self.last_id + 1
        gap = after + 1 < oldest and after < self.last_id
        out = [
            ev for ev in list(self._events)
            if ev["id"] > after and (machines is None or ev["data"].get("machine") in machines)
        ]
        return out, gap


class Subscriber:
    """One live consumer: a bounded queue the hub fans into."""

    def __init__(self, machines: Optional[Set[str]] = None, maxsize: Optional[int] = None):
        self.machines = machines
        self.queue: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue(maxsize=maxsize or queue_depth())
        self.dead = False

    def wants(self, ev: Dict[str, Any]) -> bool:
        return self.machines is None or ev["data"].get("machine") in self.machines

    def kill(self) -> None:
        """Mark dead and wake a writer blocked on the queue."""
        self.dead = True
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            pass  # a full queue wakes its reader anyway


class StreamHub:
    """The per-server hub: machine streams, event ring, subscriber fan-out.

    Handler threads ingest and subscribe concurrently: the ring and the
    subscriber set are guarded by one lock, and each machine's stream by
    its own, so a machine's rows are applied in the order they arrive.
    """

    def __init__(self, collection=None, ring_size: Optional[int] = None):
        self.collection = collection
        self.ring = EventRing(ring_size)
        self.streams: Dict[str, MachineStream] = {}
        self._subscribers: Set[Subscriber] = set()
        self._lock = threading.Lock()
        self._stream_locks: Dict[str, threading.Lock] = {}

    def subscribe(self, machines: Optional[Iterable[str]] = None, maxsize: Optional[int] = None) -> Subscriber:
        sub = Subscriber(set(machines) if machines is not None else None, maxsize)
        with self._lock:
            self._subscribers.add(sub)
        return sub

    def unsubscribe(self, sub: Subscriber) -> None:
        with self._lock:
            self._subscribers.discard(sub)

    @property
    def n_subscribers(self) -> int:
        return len(self._subscribers)

    def close(self) -> None:
        """Disconnect every subscriber (server shutdown)."""
        with self._lock:
            subs = list(self._subscribers)
        for sub in subs:
            sub.kill()

    def publish(self, etype: str, data: Dict[str, Any]) -> Dict[str, Any]:
        """Append to the ring and fan out; a subscriber whose queue is full
        is marked dead (its transport closes and it resumes by id).  The
        fan-out holds the lock too, so every queue receives ids in order
        (an SSE writer drops an id at or below the last it sent)."""
        with self._lock:
            ev = self.ring.append(etype, data)
            for sub in self._subscribers:
                if sub.dead or not sub.wants(ev):
                    continue
                try:
                    sub.queue.put_nowait(ev)
                except queue.Full:
                    sub.dead = True
        return ev

    def stream_for(self, name: str, scorer, dtype: Optional[str] = None) -> MachineStream:
        """The machine's stream, rebound when the scorer object changed."""
        ms = self.streams.get(name)
        if ms is None:
            ms = self.streams[name] = MachineStream(name, scorer, dtype)
        elif ms.scorer is not scorer:
            ms.rebind(scorer, dtype)
        return ms

    def ingest_rows(self, name: str, scorer, X: np.ndarray, dtype: Optional[str] = None) -> List[Dict[str, Any]]:
        """Feed rows for one machine; returns the events published."""
        with self._lock:
            lock = self._stream_locks.setdefault(name, threading.Lock())
        with lock:
            ms = self.stream_for(name, scorer, dtype)
            X = np.asarray(X, np.float32)
            if X.ndim == 1:
                X = X[None, :]
            events: List[Dict[str, Any]] = []
            for row in X:
                verdict = ms.ingest(row)
                if verdict is not None:
                    events.extend(self._emit(ms, verdict))
            return events

    def _emit(self, ms: MachineStream, verdict: Dict[str, Any]) -> List[Dict[str, Any]]:
        now = time.time()
        total = float(verdict["total-anomaly-score"])
        data = {
            "machine": ms.name,
            "step": ms.count,
            "time": now,
            "total-anomaly-score": total,
            "tag-anomaly-scores": [float(v) for v in verdict["tag-anomaly-scores"]],
        }
        if "anomaly-confidence" in verdict:
            data["anomaly-confidence"] = float(verdict["anomaly-confidence"])
        events = [self.publish("verdict", data)]
        det = ms.chain["detector"]
        if det["feature_thresholds"] is not None:
            threshold = float(det["aggregate_threshold"])
            exceeding = total > threshold
            if exceeding != ms.exceeding:
                ms.exceeding = exceeding
                events.append(self.publish("threshold", {
                    "machine": ms.name,
                    "direction": "above" if exceeding else "below",
                    "total-anomaly-score": total,
                    "threshold": threshold,
                    "time": now,
                }))
        # drift events read the fleet-health sketches: ROADMAP queue 1 item 10
        return events


def sse_format(ev: Dict[str, Any]) -> bytes:
    """One event as an SSE frame: ``id`` / ``event`` / ``data`` lines."""
    payload = json.dumps(ev["data"], separators=(",", ":"))
    return f"id: {ev['id']}\nevent: {ev['type']}\ndata: {payload}\n\n".encode()


def run_sse(write: Callable[[bytes], None], hub: StreamHub, sub: Subscriber, after: int) -> None:
    """Drive one SSE connection on the calling thread: replay from
    ``after``, then live fan-out with keepalive comments.  Returns when the
    subscriber dies (slow consumer, hub closed) or ``write`` raises (the
    peer went away); always unsubscribes."""
    try:
        replayed, gap = hub.ring.since(after, sub.machines)
        if gap:
            write(b": replay-gap - events before this id were trimmed\n\n")
        # subscribed before the replay, so events published meanwhile sit
        # in both the replay and the queue: the id cursor drops the copies
        sent = replayed[-1]["id"] if replayed else after
        for ev in replayed:
            write(sse_format(ev))
        while not sub.dead:
            try:
                ev = sub.queue.get(timeout=keepalive_seconds())
            except queue.Empty:
                write(b": keepalive\n\n")
                continue
            if ev is None or ev["id"] <= sent:
                continue
            sent = ev["id"]
            write(sse_format(ev))
    finally:
        hub.unsubscribe(sub)


def poll_events(hub: StreamHub, machines: Optional[Set[str]], after: int,
                timeout: Optional[float] = None) -> Dict[str, Any]:
    """Long poll: wait up to ``timeout`` for at least one event past
    ``after``, then return the batch and the resume cursor."""
    timeout = poll_timeout_seconds() if timeout is None else timeout
    # subscribe before the ring check, so an event landing between the two
    # wakes the wait (the ring re-read returns it)
    sub = hub.subscribe(machines)
    try:
        events, gap = hub.ring.since(after, machines)
        if not events and timeout > 0:
            try:
                sub.queue.get(timeout=timeout)
            except queue.Empty:
                pass
            events, gap = hub.ring.since(after, machines)
    finally:
        hub.unsubscribe(sub)
    return {
        "events": events,
        "last-event-id": events[-1]["id"] if events else after,
        "replay-gap": gap,
    }
