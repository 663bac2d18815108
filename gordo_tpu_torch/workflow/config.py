"""Project YAML → normalized machine list (counterpart of
``gordo_tpu/workflow/config.py``).

``DEFAULT_MODEL`` names the port's classes; a project YAML that names the
JAX package's (``gordo_tpu.*``) or reference-era ones builds the same
models through ``gordo_tpu_torch.registry``'s aliases.

Reference equivalent:
``gordo_components/workflow/config_elements/normalized_config.py`` (+
``machine.py``): parse ``machines:``, overlay ``globals:`` onto per-machine
entries over the built-in defaults, inject the default model (scaler +
hourglass autoencoder wrapped in a DiffBasedAnomalyDetector), and enforce
DNS-safe machine names (machine names become k8s service names downstream).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Union

import yaml

try:  # the C loader parses a 10k-machine project YAML ~5x faster
    from yaml import CSafeLoader as _SafeLoader
except ImportError:  # pragma: no cover - libyaml-less interpreter
    from yaml import SafeLoader as _SafeLoader

#: directory for the content-hash config-normalization cache (opt-in;
#: see NormalizedConfig.from_source and docs/configuration.md)
ENV_CONFIG_CACHE = "GORDO_INGEST_CONFIG_CACHE"
_CACHE_VERSION = 1

#: the reference's default machine model, in the port's dotted paths
DEFAULT_MODEL: Dict[str, Any] = {
    "gordo_tpu_torch.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {
            "gordo_tpu_torch.pipeline.Pipeline": {
                "steps": [
                    "gordo_tpu_torch.ops.scalers.MinMaxScaler",
                    {
                        "gordo_tpu_torch.models.estimator.AutoEncoder": {
                            "kind": "feedforward_hourglass"
                        }
                    },
                ]
            }
        }
    }
}

DEFAULT_EVALUATION: Dict[str, Any] = {
    "cv_mode": "full_build",
}

#: DNS-1123 label: machine names become endpoint path segments and k8s
#: service names (reference enforces the same rule).
_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]{0,61}[a-z0-9])?$")


def _deep_merge(base: Dict, overlay: Dict) -> Dict:
    """Recursive dict merge; overlay wins, nested dicts merge."""
    if not base:
        return copy.deepcopy(overlay) if overlay else {}
    if not overlay:
        return copy.deepcopy(base)
    out = copy.deepcopy(base)
    for key, value in overlay.items():
        if (
            key in out
            and isinstance(out[key], dict)
            and isinstance(value, dict)
        ):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


class Machine:
    """One machine (named tag group): the unit of model building/serving.

    Reference equivalent: ``workflow/config_elements/machine.py::Machine``.
    """

    def __init__(
        self,
        name: str,
        dataset: Dict[str, Any],
        model: Optional[Dict[str, Any]] = None,
        metadata: Optional[Dict[str, Any]] = None,
        evaluation: Optional[Dict[str, Any]] = None,
        runtime: Optional[Dict[str, Any]] = None,
        project_name: Optional[str] = None,
    ):
        if not _NAME_RE.match(name or ""):
            raise ValueError(
                f"Invalid machine name {name!r}: must be a lowercase DNS-1123 "
                "label (a-z, 0-9, '-', max 63 chars, no leading/trailing '-')"
            )
        if not dataset:
            raise ValueError(f"Machine {name!r} has no dataset config")
        self.name = name
        self.dataset = dataset
        self.model = model or copy.deepcopy(DEFAULT_MODEL)
        self.metadata = metadata or {}
        self.evaluation = evaluation or copy.deepcopy(DEFAULT_EVALUATION)
        self.runtime = runtime or {}
        self.project_name = project_name

    @classmethod
    def from_config(
        cls,
        config: Dict[str, Any],
        project_name: Optional[str] = None,
        config_globals: Optional[Dict[str, Any]] = None,
    ) -> "Machine":
        g = config_globals or {}
        return cls(
            name=config.get("name"),
            dataset=_deep_merge(g.get("dataset", {}), config.get("dataset", {})),
            model=config.get("model") or g.get("model"),
            metadata=_deep_merge(
                g.get("metadata", {}), config.get("metadata", {})
            ),
            evaluation=_deep_merge(
                g.get("evaluation", {}), config.get("evaluation", {})
            ),
            runtime=_deep_merge(g.get("runtime", {}), config.get("runtime", {})),
            project_name=project_name,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dataset": self.dataset,
            "model": self.model,
            "metadata": self.metadata,
            "evaluation": self.evaluation,
            "runtime": self.runtime,
        }

    def __repr__(self) -> str:
        return f"Machine({self.name!r})"

    @classmethod
    def _from_normalized(
        cls, d: Dict[str, Any], project_name: Optional[str] = None
    ) -> "Machine":
        """Fast constructor for ALREADY-normalized, already-validated
        machine dicts (the :meth:`NormalizedConfig.from_source` cache-hit
        path): globals were merged and names DNS-validated when the cache
        entry was written, so neither repeats here."""
        self = cls.__new__(cls)
        self.name = d["name"]
        self.dataset = d["dataset"]
        self.model = d["model"]
        self.metadata = d.get("metadata") or {}
        self.evaluation = d.get("evaluation") or copy.deepcopy(
            DEFAULT_EVALUATION
        )
        self.runtime = d.get("runtime") or {}
        self.project_name = project_name
        return self


class NormalizedConfig:
    """Parsed project config: globals overlaid onto every machine entry.

    Reference equivalent: ``NormalizedConfig`` — the single source of truth
    the builder fan-out, workflow generator, and watchman all consume.
    """

    def __init__(self, config: Dict[str, Any], project_name: str = "project"):
        if not isinstance(config, dict) or "machines" not in config:
            raise ValueError("Project config must be a mapping with 'machines'")
        self.project_name = project_name
        self.config_globals = config.get("globals", {}) or {}
        self.machines: List[Machine] = [
            Machine.from_config(m, project_name, self.config_globals)
            for m in config["machines"]
        ]
        counts = Counter(m.name for m in self.machines)
        dupes = {n for n, c in counts.items() if c > 1}
        if dupes:
            raise ValueError(f"Duplicate machine names: {sorted(dupes)}")

    @classmethod
    def from_source(
        cls,
        source: Union[str, Dict],
        project_name: str = "project",
        cache_dir: Optional[str] = None,
    ) -> "NormalizedConfig":
        """The config fast path: YAML text/path/dict → NormalizedConfig
        through the C YAML loader plus an optional content-hash cache of
        the NORMALIZED output.

        ``cache_dir`` (default: ``GORDO_INGEST_CONFIG_CACHE`` env, off
        when unset) holds one JSON file per sha256 of the raw config text
        + project name; a hit skips both the YAML parse and the
        globals-merge normalization — re-planning an unchanged
        10k-machine project drops from seconds to a file read.  Entries
        are written atomically and only when the normalized output
        round-trips JSON exactly (a YAML-date-bearing config simply never
        caches), so a hit is byte-equivalent to the cold path.
        """
        if cache_dir is None:
            cache_dir = os.environ.get(ENV_CONFIG_CACHE) or None
        text: Optional[str] = None
        if isinstance(source, str):
            text = source
            if "\n" not in source and source.endswith((".yml", ".yaml")):
                with open(source) as f:
                    text = f.read()
        path = None
        if cache_dir and text is not None:
            digest = hashlib.sha256(
                f"v{_CACHE_VERSION}\x00{project_name}\x00".encode()
                + text.encode()
            ).hexdigest()
            path = os.path.join(cache_dir, f"config-{digest}.json")
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                payload = None
            if payload is not None and payload.get("version") == _CACHE_VERSION:
                self = cls.__new__(cls)
                self.project_name = payload["project_name"]
                self.config_globals = payload["globals"]
                self.machines = [
                    Machine._from_normalized(d, self.project_name)
                    for d in payload["machines"]
                ]
                return self
        cfg = cls(
            load_machine_config(text if text is not None else source),
            project_name,
        )
        if path is not None:
            payload = {
                "version": _CACHE_VERSION,
                "project_name": project_name,
                "globals": cfg.config_globals,
                "machines": [m.to_dict() for m in cfg.machines],
            }
            try:
                blob = json.dumps(payload)
            except (TypeError, ValueError):
                return cfg  # non-JSON values (YAML dates, ...): don't cache
            if json.loads(blob) != payload:
                return cfg  # lossy round-trip (non-str keys, ...): ditto
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        return cfg


def load_machine_config(source: Union[str, Dict]) -> Dict[str, Any]:
    """YAML text, file path, or dict → raw project-config dict."""
    if isinstance(source, dict):
        return source
    text = source
    if "\n" not in source and source.endswith((".yml", ".yaml")):
        with open(source) as f:
            text = f.read()
    loaded = yaml.load(text, Loader=_SafeLoader)
    if not isinstance(loaded, dict):
        raise ValueError("Project config did not parse to a mapping")
    return loaded
