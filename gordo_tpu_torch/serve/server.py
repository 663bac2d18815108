"""HTTP serving of a port model directory.

Counterpart of ``gordo_tpu/serve/server.py`` on the standard library's
``ThreadingHTTPServer``.  Routes, JSON envelope (``{"data": ...,
"time-seconds": ...}``), keys and status codes follow the JAX handlers:

- ``GET  {p}/{machine}/healthcheck``
- ``GET  {p}/{machine}/metadata``
- ``POST {p}/{machine}/prediction``
- ``POST {p}/{machine}/anomaly/prediction``
- ``POST {p}/_bulk/anomaly/prediction``
- ``POST {p}/stream/ingest`` and ``GET {p}/stream`` (SSE, or ``?mode=poll``)

with ``{p} = /gordo/v0/<project>``.  Every scoring route goes through the
hand-written kernels (``serve/scorer.py``): per request on the per-machine
routes and per bucket on the bulk route, one ``fleet_score`` launch,
after one ``lstm_layer`` launch per layer for an LSTM model, and before
one ``rolling_median`` launch for a detector with a window.  The streaming
routes feed ``serve/stream.py``'s hub (one ``stream_step`` launch per row
of a feedforward chain).  Every scorer and stream of a collection serves
at its ``serve_dtype``.  Time-index columns, msgpack, coalescing and
``/metrics`` are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

import gordo_tpu_torch
from gordo_tpu_torch import serializer
from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.serve import precision
from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve import stream as stream_mod
from gordo_tpu_torch.serve.stream import StreamHub

logger = logging.getLogger(__name__)

class ModelEntry:
    """One served machine: its model, metadata and scorer (at the
    collection's serving precision ``dtype``)."""

    def __init__(self, name: str, directory: str, device, dtype: Optional[str] = None):
        self.name = name
        self.directory = directory
        self.model = serializer.load(directory)
        self.metadata = serializer.load_metadata(directory)
        self.scorer = CompiledScorer(self.model, device=device, machine=name, dtype=dtype)

    @property
    def tags(self) -> List[str]:
        tag_list = self.metadata.get("dataset", {}).get("tag_list") or []
        return [t["name"] if isinstance(t, dict) else str(t) for t in tag_list]


class ModelCollection:
    """All machines this server hosts: ``{name: ModelEntry}``, every scorer
    at one serving precision, :attr:`serve_dtype`."""

    def __init__(self, entries: Dict[str, ModelEntry], project: str, device,
                 serve_dtype: Optional[str] = None):
        self.entries = entries
        self.project = project
        self.device = device
        self.serve_dtype = precision.resolve(serve_dtype)
        self._fleet: Optional[FleetScorer] = None
        self._fleet_lock = threading.Lock()
        self.stream_hub = StreamHub(self)

    @classmethod
    def from_directory(
        cls, model_dir: str, project: str = "project", device=None,
        serve_dtype: Optional[str] = None,
    ) -> "ModelCollection":
        """One machine's artifact dir, or a project dir holding one artifact
        dir per machine.  ``serve_dtype``: the serving precision (``None``
        resolves ``GORDO_SERVE_DTYPE``)."""
        device = resolve_device(device)
        serve_dtype = precision.resolve(serve_dtype)
        model_dir = os.path.abspath(model_dir)
        if serializer.is_artifact_dir(model_dir):
            dirs = {os.path.basename(model_dir): model_dir}
        else:
            dirs = {
                name: os.path.join(model_dir, name)
                for name in sorted(os.listdir(model_dir))
                if serializer.is_artifact_dir(os.path.join(model_dir, name))
            }
        entries = {name: ModelEntry(name, d, device, serve_dtype) for name, d in dirs.items()}
        return cls(entries, project, device, serve_dtype)

    def get(self, name: str) -> Optional[ModelEntry]:
        return self.entries.get(name)

    @property
    def fleet_scorer(self) -> FleetScorer:
        with self._fleet_lock:
            if self._fleet is None:
                self._fleet = FleetScorer.from_models(
                    {n: e.model for n, e in self.entries.items()}, device=self.device,
                    dtype=self.serve_dtype,
                )
            return self._fleet


def parse_X(payload: Any, tags: List[str]) -> np.ndarray:
    """``{"X": ...}`` → float32 matrix.  Accepts a list-of-lists or a list
    of records keyed by tag name."""
    if not isinstance(payload, dict) or "X" not in payload:
        raise ValueError("Payload must be a JSON object with an 'X' key")
    X = payload["X"]
    if isinstance(X, list) and X and isinstance(X[0], dict):
        if not tags:
            raise ValueError("Record-style X requires model tag metadata")
        try:
            X = [[rec[t] for t in tags] for rec in X]
        except KeyError as exc:
            raise ValueError(f"Record missing tag {exc}")
    try:
        arr = np.asarray(X, dtype=np.float32)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"X is not a numeric matrix: {exc}")
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"X must be 2-dimensional, got shape {arr.shape}")
    return arr


def _validate_width(X: np.ndarray, entry: ModelEntry) -> None:
    tags = entry.tags
    if tags and X.shape[1] != len(tags):
        raise ValueError(f"X has {X.shape[1]} columns; model expects {len(tags)} tags")


def _refuse_index(payload: Any) -> None:
    if isinstance(payload, dict) and payload.get("index") is not None:
        raise ValueError(
            "index (time columns) is not served by this port yet: ROADMAP "
            "queue 1 item 9 (remaining surfaces)"
        )


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


Response = Tuple[int, Any]


class _HTTPError(Exception):
    """An error answer of a handler: ``status`` and its body."""

    def __init__(self, status: int, body: Any):
        super().__init__(status, body)
        self.status, self.body = status, body


class _Routes:
    """The handlers, as functions of (collection, machine, payload)."""

    def __init__(self, collection: ModelCollection):
        self.collection = collection

    def _parse_single(self, entry: ModelEntry, body: bytes):
        payload = json.loads(body)
        _refuse_index(payload)
        X = parse_X(payload, entry.tags)
        _validate_width(X, entry)
        y = None
        if isinstance(payload, dict) and payload.get("y") is not None:
            y = parse_X({"X": payload["y"]}, entry.tags)
        return X, y

    def healthcheck(self, entry: ModelEntry, body: bytes) -> Response:
        return 200, {"gordo-server-version": gordo_tpu_torch.__version__}

    def metadata(self, entry: ModelEntry, body: bytes) -> Response:
        return 200, {
            "endpoint-metadata": {"model-name": entry.name},
            "metadata": entry.metadata,
        }

    def prediction(self, entry: ModelEntry, body: bytes) -> Response:
        t0 = time.perf_counter()
        try:
            X, _ = self._parse_single(entry, body)
            out = entry.scorer.predict(X)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:
            logger.exception("Prediction failed for %s", entry.name)
            return 500, {"error": str(exc)}
        return 200, {
            "data": {"model-output": out},
            "time-seconds": round(time.perf_counter() - t0, 6),
        }

    def anomaly_prediction(self, entry: ModelEntry, body: bytes) -> Response:
        if not entry.scorer.is_anomaly:
            return 422, {"error": "Model is not an AnomalyDetector; use /prediction"}
        t0 = time.perf_counter()
        try:
            X, y = self._parse_single(entry, body)
            out = entry.scorer.anomaly_arrays(X, y)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:
            logger.exception("Anomaly scoring failed for %s", entry.name)
            return 500, {"error": str(exc)}
        return 200, {"data": out, "time-seconds": round(time.perf_counter() - t0, 6)}

    def bulk_anomaly_prediction(self, body: bytes) -> Response:
        """``{"X": {"<machine>": [[...rows...]], ...}}`` → one launch per bucket."""
        t0 = time.perf_counter()
        try:
            payload = json.loads(body)
            if not isinstance(payload, dict) or not isinstance(payload.get("X"), dict):
                raise ValueError("Payload must be {'X': {machine: rows}} for bulk scoring")
            _refuse_index(payload)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        X_by_name: Dict[str, np.ndarray] = {}
        errors: Dict[str, Dict[str, str]] = {}
        for name, rows in payload["X"].items():
            entry = self.collection.get(name)
            try:
                if entry is None:
                    raise ValueError(f"Unknown machine {name!r}")
                X = parse_X({"X": rows}, entry.tags)
                _validate_width(X, entry)
                X_by_name[name] = X
            except ValueError as exc:
                errors[name] = {"error": str(exc)}
        if not X_by_name and errors:
            return 400, {"error": "No valid machines in payload", "data": errors}
        try:
            out = self.collection.fleet_scorer.score_all(X_by_name)
        except Exception as exc:
            logger.exception("Bulk anomaly scoring failed")
            return 500, {"error": str(exc)}
        # "client-error" is transport metadata, not response schema
        data = {
            name: {k: v for k, v in res.items() if k != "client-error"}
            for name, res in out.items()
        }
        data.update(errors)
        return 200, {"data": data, "time-seconds": round(time.perf_counter() - t0, 6)}


    # -- streaming plane (serve/stream.py) ------------------------------------

    def _entry_or_404(self, name: str) -> ModelEntry:
        entry = self.collection.get(name)
        if entry is None:
            raise _HTTPError(404, f"Machine {name!r} not found")
        return entry

    def stream_after(self, headers, query: Dict[str, str]) -> int:
        """The resume cursor: ``Last-Event-ID``, then ``?after=``, else the
        ring head (a fresh subscriber tails live events only)."""
        hub = self.collection.stream_hub
        raw = headers.get("Last-Event-ID") or query.get("after")
        if raw is None:
            return hub.ring.last_id
        try:
            return int(raw)
        except ValueError:
            raise _HTTPError(400, {"error": f"bad event id {raw!r}"})

    def stream_ingest(self, body: bytes) -> Response:
        """``{"machine": m, "x": row-or-rows}`` or ``{"X": {machine: rows}}``
        → ``{"accepted", "events", "last-event-id"}``."""
        collection = self.collection
        hub = collection.stream_hub
        try:
            payload = json.loads(body)
        except ValueError:
            return 400, {"error": "body must be a JSON object"}
        if not isinstance(payload, dict):
            return 400, {"error": "body must be a JSON object"}
        try:
            if isinstance(payload.get("X"), dict):
                batches = list(payload["X"].items())
            elif payload.get("machine"):
                batches = [(payload["machine"], payload.get("x"))]
            else:
                raise ValueError('need {"machine": ..., "x": ...} or {"X": {machine: rows}}')
            parsed = []
            for name, rows in batches:
                entry = self._entry_or_404(name)
                X = parse_X({"X": rows}, entry.tags)
                _validate_width(X, entry)
                parsed.append((name, entry, X))
        except ValueError as exc:
            return 400, {"error": str(exc)}
        accepted = published = 0
        for name, entry, X in parsed:
            try:
                events = hub.ingest_rows(name, entry.scorer, X, dtype=collection.serve_dtype)
            except stream_mod.StreamUnsupported as exc:
                return 422, {"error": str(exc)}
            accepted += int(X.shape[0])
            published += len(events)
        return 200, {"accepted": accepted, "events": published, "last-event-id": hub.ring.last_id}

    def stream_query(self, headers, query: Dict[str, str]):
        """``(machines, after)`` of ``GET {p}/stream``; unknown machines 404."""
        machines = None
        if query.get("machines"):
            machines = [m for m in query["machines"].split(",") if m]
            for name in machines:
                self._entry_or_404(name)
        return machines, self.stream_after(headers, query)

    def stream_poll(self, machines, after: int, query: Dict[str, str]) -> Response:
        try:
            timeout = min(float(query.get("timeout", "1e9")), stream_mod.poll_timeout_seconds())
        except ValueError:
            timeout = stream_mod.poll_timeout_seconds()
        hub = self.collection.stream_hub
        return 200, stream_mod.poll_events(hub, set(machines) if machines else None, after, timeout)


class _Handler(BaseHTTPRequestHandler):
    server: "GordoHTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        logger.debug("%s - %s", self.address_string(), format % args)

    def _send(self, status: int, obj: Any) -> None:
        if isinstance(obj, str):
            body, ctype = obj.encode(), "text/plain; charset=utf-8"
        else:
            body, ctype = json.dumps(obj, default=_jsonable).encode(), "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _stream(self, query: Dict[str, str]) -> None:
        """``GET {p}/stream``: the long poll (``?mode=poll``) or SSE frames
        until the subscriber dies or the peer goes away."""
        routes = self.server.routes
        machines, after = routes.stream_query(self.headers, query)
        if query.get("mode") == "poll":
            self._send(*routes.stream_poll(machines, after, query))
            return
        hub = routes.collection.stream_hub
        sub = hub.subscribe(machines)
        self.close_connection = True  # the body ends when the connection does
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.send_header("Connection", "close")
        self.end_headers()

        def write(frame: bytes) -> None:
            self.wfile.write(frame)
            self.wfile.flush()

        try:
            stream_mod.run_sse(write, hub, sub, after)
        except (BrokenPipeError, ConnectionError):
            pass  # the peer went away; run_sse unsubscribed

    def _dispatch(self, method: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        path, _, qs = self.path.partition("?")
        query = {k: v[-1] for k, v in parse_qs(qs).items()}
        parts = path.strip("/").split("/")
        # gordo / v0 / <project> / <route...>
        if len(parts) < 4 or parts[0] != "gordo" or parts[1] != "v0":
            self._send(404, "404: Not Found")
            return
        route = parts[3:]
        routes = self.server.routes
        try:
            if method == "POST" and route == ["stream", "ingest"]:
                self._send(*routes.stream_ingest(body))
                return
            if method == "GET" and route == ["stream"]:
                self._stream(query)
                return
        except _HTTPError as exc:
            self._send(exc.status, exc.body)
            return
        if len(route) < 2:
            self._send(404, "404: Not Found")
            return
        if method == "POST" and route == ["_bulk", "anomaly", "prediction"]:
            self._send(*routes.bulk_anomaly_prediction(body))
            return
        machine, action = route[0], tuple(route[1:])
        handler = {
            ("GET", ("healthcheck",)): routes.healthcheck,
            ("GET", ("metadata",)): routes.metadata,
            ("POST", ("prediction",)): routes.prediction,
            ("POST", ("anomaly", "prediction")): routes.anomaly_prediction,
        }.get((method, action))
        if handler is None:
            self._send(404, "404: Not Found")
            return
        entry = routes.collection.get(machine)
        if entry is None:
            self._send(404, f"Machine {machine!r} not found")
            return
        self._send(*handler(entry, body))

    def do_GET(self) -> None:  # noqa: N802 - stdlib name
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802 - stdlib name
        self._dispatch("POST")


class GordoHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, collection: ModelCollection, host: str, port: int):
        self.routes = _Routes(collection)
        super().__init__((host, port), _Handler)

    def server_close(self) -> None:
        # wake and end the SSE writers before the socket closes
        self.routes.collection.stream_hub.close()
        super().server_close()


def make_server(collection: ModelCollection, host: str = "127.0.0.1", port: int = 0) -> GordoHTTPServer:
    """A bound, not yet serving, server (``port=0`` picks a free port)."""
    return GordoHTTPServer(collection, host, port)


def run_server(
    model_dir: str,
    host: str = "0.0.0.0",
    port: int = 5555,
    project: str = "project",
    device: Optional[str] = None,
) -> None:
    """Blocking entry point of ``run-server``."""
    collection = ModelCollection.from_directory(model_dir, project=project, device=device)
    server = make_server(collection, host, port)
    logger.info(
        "Serving %d machine(s) of project %s on %s:%d (%s)",
        len(collection.entries), project, host, server.server_address[1],
        collection.device,
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()
