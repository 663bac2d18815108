"""Single-machine builds (counterpart of ``gordo_tpu/builder/build_model.py``).

Reference equivalent: ``gordo_components/builder/build_model.py`` —
``build_model`` (dataset → model construction → CV → final fit → metadata)
and ``provide_saved_model`` (config-hash cache over a disk registry +
``serializer.dump``).  This module is the single-machine path and the
metadata/cache contract that the fleet build
(:mod:`gordo_tpu_torch.builder.fleet_build`) shares.

The artifact is the port's serializer directory (``serializer.dump``:
``definition.json``, ``arrays.npz``, ``fitted.json``, ``metadata.json``).
The metadata keeps the JAX package's schema; its ``gordo_tpu_version``
key holds the port's version.  The training-time fleet-health baseline
(``metadata["fleet-health"]``) waits for ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

import gordo_tpu_torch
from gordo_tpu_torch import serializer
from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.utils import disk_registry

logger = logging.getLogger(__name__)


def calculate_model_key(
    name: str,
    model_config: dict,
    data_config: dict,
    metadata: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> str:
    """Deterministic cache key: md5 over (version, name, configs, metadata)
    (reference: ``_calculate_model_key``).  Any config or framework-version
    change produces a new key → rebuild.  ``extra`` carries build-time
    options that change the trained result without living in the configs
    (e.g. ``align_lengths``); omitted/empty keeps the historical hash so
    existing caches stay valid."""
    payload_dict = {
        "gordo_tpu_version": gordo_tpu_torch.__version__,
        "name": name,
        "model_config": model_config,
        "data_config": data_config,
        "user_metadata": metadata or {},
    }
    if extra:
        payload_dict["build_options"] = extra
    payload = json.dumps(payload_dict, sort_keys=True, default=str)
    return hashlib.md5(payload.encode()).hexdigest()


def build_model(
    name: str,
    model_config: dict,
    data_config: dict,
    metadata: Optional[dict] = None,
    evaluation_config: Optional[dict] = None,
    device=None,
) -> Tuple[Any, Dict[str, Any]]:
    """Build one machine's model: data → model → (CV) → fit → metadata.
    ``device`` as :func:`gordo_tpu_torch.device.resolve_device`."""
    evaluation_config = evaluation_config or {"cv_mode": "full_build"}
    t_start = time.time()

    dataset = GordoBaseDataset.from_dict(dict(data_config))
    # X and y may alias the SAME DataFrame (autoencoder default where
    # targets == inputs) — treat both as read-only; np.asarray below copies
    X, y = dataset.get_data()
    t_data = time.time()

    model = serializer.from_definition(dict(model_config))

    X_arr = np.asarray(X, dtype=np.float32)
    y_arr = np.asarray(y, dtype=np.float32)

    cv_meta: Dict[str, Any] = {}
    cv_duration = 0.0
    cv_mode = evaluation_config.get("cv_mode", "full_build")
    if cv_mode != "build_only" and hasattr(model, "cross_validate"):
        t0 = time.time()
        model.cross_validate(X_arr, y_arr, cv=evaluation_config.get("cv"), device=device)
        cv_duration = time.time() - t0
        cv_meta = getattr(model, "cv_metadata_", {})

    if cv_mode == "cross_val_only":
        fit_duration = 0.0
    else:
        t0 = time.time()
        model.fit(X_arr, y_arr, device=device)
        fit_duration = time.time() - t0

    build_metadata = assemble_metadata(
        name=name,
        model=model,
        model_config=model_config,
        data_config=data_config,
        dataset_metadata=dataset.get_metadata(),
        metadata=metadata,
        data_query_duration=t_data - t_start,
        cv_duration=cv_duration,
        fit_duration=fit_duration,
        cv_meta=cv_meta,
    )
    return model, build_metadata


def assemble_metadata(
    name: str,
    model: Any,
    model_config: dict,
    data_config: dict,
    dataset_metadata: dict,
    metadata: Optional[dict],
    data_query_duration: float,
    cv_duration: float,
    fit_duration: float,
    cv_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The machine-metadata schema shared by the single-machine and fleet
    builders (reference parity: the metadata JSON is the primary
    observability artifact, SURVEY.md §6.5)."""
    metadata = metadata or {}
    cv_meta = cv_meta or {}
    return {
        "name": name,
        "gordo_tpu_version": gordo_tpu_torch.__version__,
        "checksum": calculate_model_key(name, model_config, data_config, metadata),
        "dataset": dataset_metadata,
        "model": {
            "model_config": model_config,
            "model_creation_date": time.strftime("%Y-%m-%d %H:%M:%S%z"),
            "data_query_duration_sec": data_query_duration,
            "cross_validation_duration_sec": cv_duration,
            "model_builder_duration_sec": fit_duration,
            **(
                {
                    "fit_samples_per_second": round(
                        dataset_metadata["rows_after_filter"] / fit_duration, 1
                    )
                }
                if fit_duration and dataset_metadata.get("rows_after_filter")
                else {}
            ),
            **(
                {"cross_validation": cv_meta}
                if cv_meta
                else {}
            ),
            **(
                model.get_metadata() if hasattr(model, "get_metadata") else {}
            ),
        },
        "user_defined": metadata,
    }


def lookup_cached_artifact(
    model_register_dir: str, cache_key: str, name: str
) -> Optional[str]:
    """Registry lookup that verifies the artifact still IS what the key
    says: per-machine artifact dirs get overwritten on config-changed
    rebuilds, so a stale registry entry can point at a dir now holding a
    DIFFERENT build.  Artifacts stamp their own ``cache_key`` in metadata
    at dump time; a mismatch is treated as a miss.  (Artifacts from before
    this stamp carry no key and are accepted as-is.)"""
    cached = disk_registry.get_value(model_register_dir, cache_key)
    if not cached:
        return None
    if not serializer.is_artifact_dir(cached):
        logger.warning(
            "Registry entry for %s points at missing artifact %s; rebuilding",
            name, cached,
        )
        return None
    try:
        stored = serializer.load_metadata(cached).get("cache_key")
    except Exception:
        stored = None
    if stored is not None and stored != cache_key:
        logger.warning(
            "Artifact %s was overwritten by a different build (stored key "
            "%s != %s); treating as cache miss", cached, stored, cache_key,
        )
        return None
    logger.info("Cache hit for %s (key %s): %s", name, cache_key, cached)
    return cached


def provide_saved_model(
    name: str,
    model_config: dict,
    data_config: dict,
    metadata: Optional[dict] = None,
    output_dir: str = "./models",
    model_register_dir: Optional[str] = None,
    replace_cache: bool = False,
    evaluation_config: Optional[dict] = None,
    device=None,
) -> str:
    """Cache-aware build: return an artifact dir, training only on miss
    (reference: ``provide_saved_model``)."""
    cache_key = calculate_model_key(name, model_config, data_config, metadata)

    if model_register_dir and not replace_cache:
        cached = lookup_cached_artifact(model_register_dir, cache_key, name)
        if cached is not None:
            return cached

    model, build_metadata = build_model(
        name, model_config, data_config, metadata, evaluation_config, device=device
    )
    build_metadata["cache_key"] = cache_key
    dest = os.path.join(output_dir, name) if os.path.basename(
        os.path.normpath(output_dir)
    ) != name else output_dir
    serializer.dump(model, dest, metadata=build_metadata)

    if model_register_dir:
        disk_registry.write_key(model_register_dir, cache_key, os.path.abspath(dest))
    return dest
