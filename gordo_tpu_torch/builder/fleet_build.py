"""Project-scale builds: the whole machine list through the fleet engine
(counterpart of ``gordo_tpu/builder/fleet_build.py``).

Machines are bucketed by model signature and tag widths from the CONFIG
alone (no data loaded); each bucket trains in chunks of at most
``max_bucket_size`` machines as one ``FleetDiffBuilder`` build on the card
(``parallel/anomaly.py``: ``fleet_init``, ``scaler_stats``, ``fleet_fit``,
``cv_epilogue``).  Every machine still gets its own artifact directory,
metadata JSON and config-hash cache entry (``provide_saved_model``'s
contract): a re-run skips machines already built, and a machine whose
config the fleet engine cannot express builds through the single-machine
path.

The drive loop is the JAX package's: a loader pool prefetches one chunk
ahead (at most two chunks of arrays resident, ``peak_loaded``), chunk k+1
is dispatched before chunk k is collected, and a background writer pool
writes each artifact into a scratch directory and renames it into place.

What this port writes and reads, and what it refuses:

- the v1 layout, one directory per machine (``serializer.dump``);
  ``artifact_format="v2"`` (or ``GORDO_ARTIFACT_FORMAT=v2``), the
  memory-mapped packs, raises ``NotImplementedError`` naming ROADMAP queue
  1 item 4 (4c);
- per-machine loading (``dataset.get_data()``); ``ingest=True`` (or
  ``GORDO_INGEST=on``), the fleet ingest plane, raises naming item 4
  (4b).  An unset environment resolves to v1 and per-machine loading;
- ``warm_start=True`` raises naming item 4 (4c): it resolves the previous
  generation's params through the v2 pack index;
- ``shard`` and ``mesh`` raise naming item 11 (placement and
  multi-host builds).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.build_model import (
    assemble_metadata,
    build_model,
    calculate_model_key,
    lookup_cached_artifact,
)
from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.utils import disk_registry
from gordo_tpu_torch.workflow.config import Machine

logger = logging.getLogger(__name__)

ARTIFACTS_ITEM = "ROADMAP queue 1 item 4 (4c: v2 artifact packs and warm refresh)"
INGEST_ITEM = "ROADMAP queue 1 item 4 (4b: the fleet ingest plane)"
PLACEMENT_ITEM = "ROADMAP queue 1 item 11 (placement: meshes and multi-host builds)"

#: machines per fleet chunk (the JAX package's defaults,
#: ``gordo_tpu/builder/fleet_build.py:249,262``)
DEFAULT_MAX_BUCKET = 512
DEFAULT_MAX_BUCKET_LSTM = 128

#: auto-pad (the JAX package's ``:274,282``): when neither ragged strategy
#: is chosen and the config-level estimate of per-distinct-length compile
#: seconds exceeds the budget, ``pad_lengths`` is turned on.  The port
#: compiles nothing per shape, but a pad-built detector differs from an
#: exact one, so it takes the JAX package's decision on the same configs.
DEFAULT_AUTO_PAD_BUDGET_SECONDS = 300.0
DEFAULT_AUTO_PAD_LENGTHS = 128
#: the JAX package's measured per-distinct-length XLA compile cost
#: (``gordo_tpu/workflow/generator.py:78``), the unit of the estimate
COMPILE_SECONDS_PER_LENGTH = 13.7


def _fleet_signature(machine: Machine) -> str:
    """Static bucketing signature of the estimate: model config and tag
    width (``gordo_tpu/workflow/generator.py:63``)."""
    n_tags = len(machine.dataset.get("tag_list") or machine.dataset.get("tags") or [])
    return json.dumps({"model": machine.model, "n_tags": n_tags}, sort_keys=True)


def _ragged_length_estimate(members: List[Machine]) -> int:
    """Upper estimate of distinct train row counts in one bucket: one per
    (train window, resolution), plus one per machine with a row filter
    (``gordo_tpu/workflow/generator.py:81``)."""
    windows = set()
    filtered = 0
    for m in members:
        ds = m.dataset
        if ds.get("row_filter"):
            filtered += 1
        else:
            windows.add((
                str(ds.get("train_start_date")),
                str(ds.get("train_end_date")),
                str(ds.get("resolution")),
            ))
    return len(windows) + filtered


def estimate_ragged_compile_seconds(machines: Sequence[Machine]) -> float:
    """The JAX package's config-level estimate of the extra compile
    seconds an exact build of ``machines`` would pay for ragged lengths
    (one program per distinct row count beyond one per bucket)."""
    buckets: Dict[str, List[Machine]] = {}
    for m in machines:
        buckets.setdefault(_fleet_signature(m), []).append(m)
    if not buckets:
        return 0.0
    est_lengths = sum(_ragged_length_estimate(members) for members in buckets.values())
    extra = est_lengths - len(buckets)  # 1 compile per bucket is the floor
    return max(0.0, extra * COMPILE_SECONDS_PER_LENGTH)


def default_bucket_size(spec) -> int:
    """Per-signature ``max_bucket_size`` default: recurrent estimators
    (``lookback_window > 1``) chunk at ``DEFAULT_MAX_BUCKET_LSTM``,
    everything else at ``DEFAULT_MAX_BUCKET``."""
    est = getattr(spec, "estimator_proto", None)
    if getattr(est, "lookback_window", 1) > 1:
        return DEFAULT_MAX_BUCKET_LSTM
    return DEFAULT_MAX_BUCKET


#: the stages of a build, in ``ProjectBuildResult.stage_seconds``
STAGES = ("config", "load", "dispatch", "collect", "assemble", "write")


class ProjectBuildResult:
    """Per-machine artifact dirs + build accounting for one project build."""

    def __init__(self):
        self.artifacts: Dict[str, str] = {}
        self.cached: List[str] = []
        self.fleet_built: List[str] = []
        self.single_built: List[str] = []
        self.failed: Dict[str, str] = {}
        self.seconds: float = 0.0
        #: high-water mark of machines whose (X, y) arrays were resident
        #: at once: the streaming loop bounds it at two chunks
        self.peak_loaded: int = 0
        #: the pad_lengths auto-pad selected (None: off, explicit, or not
        #: triggered)
        self.auto_pad: Optional[int] = None
        #: whether the pipelined drive loop ran
        self.pipelined: bool = False
        #: seconds the drive loop held no dispatched chunk in flight (a
        #: host-side lower bound on the card's idle time)
        self.device_idle_seconds: float = 0.0
        self.artifact_format: str = "v1"
        self.loader_workers: int = 0
        #: busy seconds by stage (:data:`STAGES`): config (cache keys,
        #: lookups, model analysis), load (loader pool, per machine),
        #: dispatch, collect (waiting for the card and copying back),
        #: assemble (detector objects), write (artifacts and registry)
        self.stage_seconds: Dict[str, float] = {s: 0.0 for s in STAGES}
        self._stage_lock = threading.Lock()

    def add_stage(self, stage: str, seconds: float) -> None:
        with self._stage_lock:
            self.stage_seconds[stage] += seconds

    def summary(self) -> Dict[str, Any]:
        out = {
            "n_machines": len(self.artifacts) + len(self.failed),
            "cached": len(self.cached),
            "fleet_built": len(self.fleet_built),
            "single_built": len(self.single_built),
            "failed": dict(self.failed),
            "build_seconds": self.seconds,
            "peak_loaded_machines": self.peak_loaded,
            "pipelined": self.pipelined,
            "device_idle_seconds": self.device_idle_seconds,
            "artifact_format": self.artifact_format,
            "stage_seconds": dict(self.stage_seconds),
        }
        if self.loader_workers:
            out["loader_workers"] = self.loader_workers
        if self.auto_pad:
            out["auto_pad_lengths"] = self.auto_pad
        return out


class _LoadTracker:
    """Counts machines with live arrays; records the high-water mark."""

    def __init__(self):
        self._lock = threading.Lock()
        self.current = 0
        self.peak = 0

    def acquire(self) -> None:
        with self._lock:
            self.current += 1
            self.peak = max(self.peak, self.current)

    def release(self, n: int = 1) -> None:
        with self._lock:
            self.current -= n


class _DeviceOccupancy:
    """Accumulates the windows in which no dispatched chunk was in flight."""

    def __init__(self):
        self._inflight = 0
        self._idle_since: Optional[float] = time.time()
        self.idle_seconds = 0.0

    def dispatched(self) -> None:
        if self._inflight == 0 and self._idle_since is not None:
            self.idle_seconds += time.time() - self._idle_since
            self._idle_since = None
        self._inflight += 1

    def collected(self) -> None:
        self._inflight -= 1
        if self._inflight == 0:
            self._idle_since = time.time()


class _ArtifactWriter:
    """Background artifact-writer pool behind a bounded queue:
    :meth:`submit` blocks once ``max_queued`` writes are outstanding, so a
    slow disk holds the drive loop back instead of buffering unbounded
    fleets.  The write function places each artifact atomically and
    records its own failures; :meth:`drain` waits for every write."""

    def __init__(self, write_fn: Callable[..., None], max_workers: int = 1, max_queued: int = 512):
        self._write_fn = write_fn
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="gordo-artifact-writer")
        self._slots = threading.BoundedSemaphore(max_queued)
        self._futures: List[Any] = []

    def submit(self, items: Sequence[Tuple]) -> None:
        """Queue one chunk's writes as one pool task; blocks for a queue
        slot per artifact."""
        for _ in items:
            self._slots.acquire()
        self._futures.append(self._pool.submit(self._run, list(items)))

    def _run(self, items: List[Tuple]) -> None:
        for args in items:
            try:
                self._write_fn(*args)
            finally:
                self._slots.release()

    def drain(self) -> None:
        futures, self._futures = self._futures, []
        for fut in futures:
            fut.result()
        self._pool.shutdown(wait=True)


@dataclasses.dataclass
class _PendingChunk:
    """One chunk between its dispatch and its collect."""

    key: Tuple
    ok_chunk: List[Machine]
    loaded: Dict[str, Tuple]
    t0: float
    pending: Any


def _as_machine(m: Union[Machine, Dict[str, Any]]) -> Machine:
    return m if isinstance(m, Machine) else Machine.from_config(m)


def _config_widths(dataset_cfg: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    """(n_features, n_outputs) from the dataset config alone, or None."""
    tags = dataset_cfg.get("tag_list") or dataset_cfg.get("tags")
    if not tags:
        return None
    targets = dataset_cfg.get("target_tag_list") or tags
    return len(tags), len(targets)


def _switch_on(value: Optional[str]) -> bool:
    return value is not None and value.strip().lower() not in ("", "off", "0", "false")


def resolve_artifact_format(artifact_format: Optional[str]) -> str:
    """``"v1"``, the only layout the port writes; ``artifact_format`` or
    ``GORDO_ARTIFACT_FORMAT`` naming ``"v2"`` raises."""
    fmt = (artifact_format or os.environ.get("GORDO_ARTIFACT_FORMAT") or "v1").strip().lower()
    if fmt == "v2":
        raise NotImplementedError(f"artifact_format='v2' (memory-mapped packs) waits for {ARTIFACTS_ITEM}")
    if fmt != "v1":
        raise ValueError(f"artifact_format must be 'v1' or 'v2', got {fmt!r}")
    return fmt


def _pipeline_enabled(pipeline: Optional[bool]) -> bool:
    """``GORDO_BUILD_PIPELINE=off`` forces the serial drive loop; an
    explicit ``pipeline=`` wins over the environment."""
    if pipeline is not None:
        return bool(pipeline)
    return os.environ.get("GORDO_BUILD_PIPELINE", "on").strip().lower() not in ("off", "0", "false")


def build_project(
    machines: Sequence[Union[Machine, Dict[str, Any]]],
    output_dir: str,
    model_register_dir: Optional[str] = None,
    mesh: Any = None,
    replace_cache: bool = False,
    max_bucket_size: Optional[int] = None,
    data_workers: Optional[int] = None,
    align_lengths: Optional[int] = None,
    pad_lengths: Optional[int] = None,
    auto_pad: bool = True,
    auto_pad_budget_seconds: Optional[float] = None,
    shard: Any = None,
    pipeline: Optional[bool] = None,
    artifact_format: Optional[str] = None,
    warm_start: bool = False,
    ingest: Optional[bool] = None,
    device=None,
) -> ProjectBuildResult:
    """Build every machine; fleet-bucket the homogeneous ones.

    Arguments as the JAX package's ``build_project``, with ``device`` (as
    :func:`gordo_tpu_torch.device.resolve_device`: CUDA unless the caller
    passes ``"cpu"``).  ``align_lengths`` truncates each fleet machine's
    rows down to a multiple (oldest rows drop); ``pad_lengths`` pads them
    up with weight-masked rows (``FleetDiffBuilder(pad_lengths=)``); the
    two exclude each other, and either enters the cache key.  ``auto_pad``
    turns on ``pad_lengths=128`` when :func:`estimate_ragged_compile_seconds`
    exceeds ``auto_pad_budget_seconds`` (default 300), as the JAX package
    decides.  ``pipeline`` (default on, ``GORDO_BUILD_PIPELINE=off``)
    overlaps loads, the card and artifact writes.  ``data_workers``:
    loader threads (default: the host's cores less one, 2 to 8).

    ``artifact_format="v2"``, ``ingest=True``, ``warm_start=True``,
    ``shard`` and ``mesh`` raise ``NotImplementedError`` (module
    docstring); unset, the environment resolves to v1 and per-machine
    loading.  Returns a :class:`ProjectBuildResult`.
    """
    t_start = time.time()
    if mesh is not None:
        raise NotImplementedError(f"build_project over a mesh waits for {PLACEMENT_ITEM}")
    if shard is not None:
        raise NotImplementedError(f"a multi-host shard of build_project waits for {PLACEMENT_ITEM}")
    if warm_start:
        raise NotImplementedError(
            f"warm_start=True resolves the previous params through v2 packs and waits for {ARTIFACTS_ITEM}"
        )
    if ingest if ingest is not None else _switch_on(os.environ.get("GORDO_INGEST")):
        raise NotImplementedError(f"ingest=True (GORDO_INGEST) waits for {INGEST_ITEM}")
    if align_lengths is not None and align_lengths < 2:
        raise ValueError(
            f"align_lengths must be >= 2 (got {align_lengths}); it is a row-count multiple"
        )
    if pad_lengths is not None and pad_lengths < 2:
        raise ValueError(f"pad_lengths must be >= 2 (got {pad_lengths}); it is a row-count multiple")
    if align_lengths and pad_lengths:
        raise ValueError(
            "align_lengths (truncate down) and pad_lengths (pad up) are "
            "mutually exclusive — pick one ragged-fleet strategy"
        )
    result = ProjectBuildResult()
    result.artifact_format = resolve_artifact_format(artifact_format)
    dev = resolve_device(device)
    machines = [_as_machine(m) for m in machines]
    if data_workers is None:
        data_workers = max(2, min(8, (os.cpu_count() or 2) - 1))
    result.loader_workers = int(data_workers)
    tracker = _LoadTracker()
    occupancy = _DeviceOccupancy()

    # the auto-pad decision runs over the whole machine list, as the JAX
    # package's, so a re-run of the same configs reaches the same strategy
    if auto_pad and align_lengths is None and pad_lengths is None:
        budget = (DEFAULT_AUTO_PAD_BUDGET_SECONDS if auto_pad_budget_seconds is None
                  else auto_pad_budget_seconds)
        bill = estimate_ragged_compile_seconds(machines)
        if bill > budget:
            pad_lengths = DEFAULT_AUTO_PAD_LENGTHS
            result.auto_pad = pad_lengths
            logger.warning(
                "AUTO-PAD: configs predict ~%.0fs of per-distinct-length compiles in the "
                "JAX package's estimate (> %.0fs budget): enabling pad_lengths=%d, as it "
                "would. Pass auto_pad=False (--no-auto-pad) for exact-parity mode.",
                bill, budget, pad_lengths,
            )

    # alignment or padding changes what trains, so it enters the cache key
    # of fleet-built machines (singles train on full data, keyed without)
    key_extra = None
    if align_lengths:
        key_extra = {"align_lengths": align_lengths}
    elif pad_lengths:
        key_extra = {"pad_lengths": pad_lengths}

    # 1. Fleetability from the config alone, and the config-hash cache
    t_config = time.time()

    def _analyze(m: Machine):
        cv_mode = m.evaluation.get("cv_mode", "full_build")
        widths = _config_widths(m.dataset)
        spec = None
        if cv_mode == "full_build" and widths is not None:
            try:
                spec = analyze_definition(serializer.from_definition(dict(m.model)))
            except Exception:
                spec = None
        if spec is None and widths is None and cv_mode == "full_build":
            logger.warning(
                "Machine %s has no tag_list/tags in its dataset config; building single "
                "(fleet bucketing needs config-derivable widths)", m.name,
            )
        return spec, widths

    def _lookup(key: str, m: Machine) -> bool:
        if model_register_dir and not replace_cache:
            cached = lookup_cached_artifact(model_register_dir, key, m.name)
            if cached is not None:
                result.artifacts[m.name] = cached
                result.cached.append(m.name)
                return True
        return False

    buckets: Dict[Tuple, List[Machine]] = {}
    singles: List[Machine] = []
    specs: Dict[Tuple, Any] = {}
    machine_keys: Dict[str, str] = {}
    demoted: set = set()
    for m in machines:
        key = calculate_model_key(m.name, m.model, m.dataset, m.metadata, extra=key_extra)
        machine_keys[m.name] = key
        if _lookup(key, m):
            continue
        spec, widths = _analyze(m)
        if spec is None and key_extra is not None:
            # a single trains on its full data: it keys without alignment
            key = calculate_model_key(m.name, m.model, m.dataset, m.metadata)
            machine_keys[m.name] = key
            if _lookup(key, m):
                continue
        if spec is None:
            singles.append(m)
            continue
        bkey = (spec.signature, widths, str(m.evaluation.get("cv")))
        buckets.setdefault(bkey, []).append(m)
        specs[bkey] = spec

    chunks: List[Tuple[Tuple, List[Machine]]] = []
    for key, bucket in buckets.items():
        size = max_bucket_size or default_bucket_size(specs[key])
        for start in range(0, len(bucket), size):
            chunks.append((key, bucket[start: start + size]))
    result.add_stage("config", time.time() - t_config)

    def _demote_to_single(m: Machine) -> None:
        """A fleet machine the single path builds on its full data: its
        key drops the alignment component, and the singles pass looks it
        up again under that key."""
        if key_extra:
            machine_keys[m.name] = calculate_model_key(m.name, m.model, m.dataset, m.metadata)
            demoted.add(m.name)
        singles.append(m)

    def _load(m: Machine):
        t0 = time.time()
        dataset = GordoBaseDataset.from_dict(dict(m.dataset))
        X, y = dataset.get_data()
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if align_lengths and len(X) >= align_lengths:
            keep = (len(X) // align_lengths) * align_lengths
            X, y = X[len(X) - keep:], y[len(y) - keep:]  # the newest rows stay
        seconds = time.time() - t0
        result.add_stage("load", seconds)
        tracker.acquire()  # arrays are live from here until freed
        return X, y, dataset.get_metadata(), seconds

    def _submit(pool, chunk: List[Machine]):
        return {m.name: pool.submit(_load, m) for m in chunk}

    def _collect_loads(chunk: List[Machine], futures) -> Dict[str, Tuple]:
        loaded: Dict[str, Tuple] = {}
        for m in chunk:
            try:
                loaded[m.name] = futures[m.name].result()
            except Exception as exc:  # a data failure must not sink the fleet
                logger.exception("Data load failed for %s", m.name)
                result.failed[m.name] = f"data: {exc}"
        return loaded

    def _free(loaded: Dict[str, Tuple], names: Sequence[str]) -> None:
        n = sum(loaded.pop(name, None) is not None for name in list(names))
        if n:
            tracker.release(n)

    def _dispatch_bucket(key: Tuple, chunk: List[Machine], loaded) -> Optional[_PendingChunk]:
        """Check widths and dispatch one chunk; returns without waiting
        for the card (the fetch is in ``_finish_bucket``)."""
        spec, widths = specs[key], key[1]
        ok_chunk = []
        for m in chunk:
            if m.name not in loaded:
                continue
            X, y = loaded[m.name][0], loaded[m.name][1]
            if (X.shape[1], y.shape[1]) != widths:
                logger.warning("Machine %s loaded widths %s != config %s; building single",
                               m.name, (X.shape[1], y.shape[1]), widths)
                _demote_to_single(m)
                _free(loaded, [m.name])
            else:
                ok_chunk.append(m)
        if not ok_chunk:
            return None
        cv = ok_chunk[0].evaluation.get("cv")
        t0 = time.time()
        try:
            builder = FleetDiffBuilder(spec, cv=cv, pad_lengths=pad_lengths, device=dev)
            pending = builder.dispatch([loaded[m.name][0] for m in ok_chunk],
                                       [loaded[m.name][1] for m in ok_chunk])
        except Exception:
            logger.exception("Fleet dispatch failed; falling back to singles")
            for m in ok_chunk:
                _demote_to_single(m)
            _free(loaded, [m.name for m in ok_chunk])
            return None
        occupancy.dispatched()
        result.add_stage("dispatch", time.time() - t0)
        return _PendingChunk(key=key, ok_chunk=ok_chunk, loaded=loaded, t0=t0, pending=pending)

    def _finish_bucket(rec: _PendingChunk):
        """Collect one dispatched chunk (fetch and assembly); a failure
        demotes the chunk to singles."""
        try:
            detectors = rec.pending.collect()
        except Exception:
            logger.exception("Fleet bucket failed; falling back to singles")
            for m in rec.ok_chunk:
                _demote_to_single(m)
            _free(rec.loaded, [m.name for m in rec.ok_chunk])
            return None
        finally:
            occupancy.collected()
        result.add_stage("collect", rec.pending.fetch_seconds)
        result.add_stage("assemble", rec.pending.assemble_seconds)
        return detectors, time.time() - rec.t0

    def _finish_chunk(rec: _PendingChunk, writer: Optional[_ArtifactWriter]) -> None:
        out = _finish_bucket(rec)
        if out is None:
            return
        detectors, fleet_seconds = out
        per_machine = fleet_seconds / len(rec.ok_chunk)
        if writer is None:  # the serial path writes in place, inline
            for m, det in zip(rec.ok_chunk, detectors):
                t0 = time.time()
                try:
                    _dump_machine(
                        m, det, rec.loaded[m.name], per_machine, output_dir, model_register_dir,
                        result, fleet=True, align_lengths=align_lengths, pad_lengths=pad_lengths,
                        cache_key=machine_keys[m.name],
                    )
                except Exception as exc:
                    logger.exception("Artifact write failed for %s", m.name)
                    result.failed[m.name] = f"write: {exc}"
                result.add_stage("write", time.time() - t0)
                _free(rec.loaded, [m.name])
            return
        batch = []
        for m, det in zip(rec.ok_chunk, detectors):
            metadata = _machine_metadata(
                m, det, rec.loaded[m.name], per_machine, fleet=True,
                align_lengths=align_lengths, pad_lengths=pad_lengths,
                cache_key=machine_keys[m.name],
            )
            _free(rec.loaded, [m.name])  # arrays drop at enqueue, not at write
            batch.append((m.name, det, metadata))
        writer.submit(batch)  # one handoff per chunk

    tmp_root = os.path.join(output_dir, ".gordo-tmp")

    def _write_one(name: str, det, metadata: Dict[str, Any]) -> None:
        """Atomic artifact write and its records; a failure fails this
        machine only."""
        t0 = time.time()
        dest = os.path.join(output_dir, name)
        try:
            _write_artifact(det, metadata, dest, model_register_dir, metadata.get("cache_key"),
                            tmp_root=tmp_root)
        except Exception as exc:
            logger.exception("Artifact write failed for %s", name)
            result.failed[name] = f"write: {exc}"
            return
        finally:
            result.add_stage("write", time.time() - t0)
        result.artifacts[name] = dest
        result.fleet_built.append(name)

    def _drive_serial(pool) -> None:
        """Loads prefetch one chunk ahead; dispatch, collect and writes
        run back to back."""
        futures = _submit(pool, chunks[0][1]) if chunks else None
        for i, (key, chunk) in enumerate(chunks):
            loaded = _collect_loads(chunk, futures)
            futures = _submit(pool, chunks[i + 1][1]) if i + 1 < len(chunks) else None
            rec = _dispatch_bucket(key, chunk, loaded)
            if rec is not None:
                _finish_chunk(rec, None)

    def _drive_pipeline(pool, writer: _ArtifactWriter) -> None:
        """Loader pool ∥ the card ∥ writer pool: chunk k+1 is dispatched
        before chunk k is collected, and chunk k+2's loads are submitted
        only after chunk k's arrays are freed (two chunks resident)."""
        futures = _submit(pool, chunks[0][1])
        prev: Optional[_PendingChunk] = None
        for i, (key, chunk) in enumerate(chunks):
            loaded = _collect_loads(chunk, futures)
            rec = _dispatch_bucket(key, chunk, loaded)
            if prev is not None:
                _finish_chunk(prev, writer)  # overlaps chunk i on the card
            prev = rec
            futures = _submit(pool, chunks[i + 1][1]) if i + 1 < len(chunks) else None
        if prev is not None:
            _finish_chunk(prev, writer)

    use_pipeline = _pipeline_enabled(pipeline) and bool(chunks)
    result.pipelined = use_pipeline
    writer: Optional[_ArtifactWriter] = None
    with ThreadPoolExecutor(max_workers=data_workers) as pool:
        if use_pipeline:
            writer = _ArtifactWriter(_write_one)
            try:
                _drive_pipeline(pool, writer)
            except BaseException:
                writer.drain()
                raise
        else:
            _drive_serial(pool)

    if singles and (align_lengths or pad_lengths):
        which = f"align_lengths={align_lengths}" if align_lengths else f"pad_lengths={pad_lengths}"
        logger.warning(
            "%s does not apply to the %d machine(s) building through the single-machine "
            "path (%s%s): they train on their full unmodified data",
            which, len(singles), ", ".join(m.name for m in singles[:5]),
            "..." if len(singles) > 5 else "",
        )
    for m in singles:
        if m.name in demoted and _lookup(machine_keys[m.name], m):
            continue
        try:
            model, metadata = build_model(m.name, m.model, m.dataset, m.metadata, m.evaluation,
                                          device=dev)
        except Exception as exc:
            logger.exception("Single build failed for %s", m.name)
            result.failed[m.name] = f"build: {exc}"
            continue
        metadata["cache_key"] = machine_keys[m.name]
        t0 = time.time()
        dest = os.path.join(output_dir, m.name)
        serializer.dump(model, dest, metadata=metadata)
        _register(dest, model_register_dir, machine_keys[m.name])
        result.add_stage("write", time.time() - t0)
        result.artifacts[m.name] = dest
        result.single_built.append(m.name)

    if writer is not None:
        writer.drain()
        shutil.rmtree(tmp_root, ignore_errors=True)
    result.seconds = time.time() - t_start
    result.peak_loaded = tracker.peak
    result.device_idle_seconds = occupancy.idle_seconds
    return result


def _machine_metadata(
    m: Machine,
    detector,
    loaded_entry: Tuple,
    fit_seconds: float,
    fleet: bool,
    align_lengths: Optional[int] = None,
    pad_lengths: Optional[int] = None,
    cache_key: Optional[str] = None,
) -> Dict[str, Any]:
    """One machine's artifact metadata, the JAX package's schema (without
    the fleet-health baseline, ROADMAP queue 1 item 10)."""
    X, _, dataset_meta, query_seconds = loaded_entry
    metadata = assemble_metadata(
        name=m.name,
        model=detector,
        model_config=m.model,
        data_config=m.dataset,
        dataset_metadata=dataset_meta,
        metadata=m.metadata,
        data_query_duration=query_seconds,
        cv_duration=fit_seconds,  # fleet: CV and fit are one build
        fit_duration=fit_seconds,
        cv_meta=getattr(detector, "cv_metadata_", {}),
    )
    metadata["model"]["fleet_built"] = fleet
    if align_lengths:
        metadata["model"]["align_lengths"] = int(align_lengths)
        metadata["model"]["rows_trained"] = int(X.shape[0])
    if pad_lengths and getattr(detector, "pad_built_", False):
        metadata["model"]["pad_lengths"] = int(pad_lengths)
        metadata["model"]["rows_trained"] = int(X.shape[0])
    if cache_key is not None:
        metadata["cache_key"] = cache_key
    return metadata


def _write_artifact(
    detector,
    metadata: Dict[str, Any],
    dest: str,
    model_register_dir: Optional[str],
    cache_key: Optional[str],
    tmp_root: Optional[str] = None,
) -> None:
    """Serialize one artifact to ``dest`` and register it.  With
    ``tmp_root`` (the pipelined path) the artifact is dumped into a scratch
    dir and renamed into place, so a kill mid-write leaves no dir or a
    whole one; the registry entry follows the rename."""
    if tmp_root is None:
        serializer.dump(detector, dest, metadata=metadata)
    else:
        tmp = os.path.join(tmp_root, f"{os.path.basename(dest)}.{uuid.uuid4().hex[:8]}")
        serializer.dump(detector, tmp, metadata=metadata)
        if os.path.isdir(dest):  # rebuild over an existing artifact dir
            shutil.rmtree(dest)
        os.replace(tmp, dest)
    _register(dest, model_register_dir, cache_key)


def _dump_machine(
    m: Machine,
    detector,
    loaded_entry: Tuple,
    fit_seconds: float,
    output_dir: str,
    model_register_dir: Optional[str],
    result: ProjectBuildResult,
    fleet: bool,
    align_lengths: Optional[int] = None,
    pad_lengths: Optional[int] = None,
    cache_key: Optional[str] = None,
) -> None:
    """Artifact dump with its metadata and bookkeeping inline."""
    metadata = _machine_metadata(
        m, detector, loaded_entry, fit_seconds, fleet=fleet,
        align_lengths=align_lengths, pad_lengths=pad_lengths, cache_key=cache_key,
    )
    dest = os.path.join(output_dir, m.name)
    _write_artifact(detector, metadata, dest, model_register_dir, cache_key)
    result.artifacts[m.name] = dest
    result.fleet_built.append(m.name)


def _register(dest: str, model_register_dir: Optional[str], key: Optional[str]) -> None:
    """Registry write under the key computed once in step 1, so the stamp
    in metadata, the registry entry and the next run's lookup agree."""
    if model_register_dir and key:
        disk_registry.write_key(model_register_dir, key, os.path.abspath(dest))
