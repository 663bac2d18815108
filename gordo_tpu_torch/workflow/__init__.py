"""Project-config normalization (counterpart of ``gordo_tpu/workflow``;
the workflow generator is ROADMAP queue 1 item 12)."""

from gordo_tpu_torch.workflow.config import (
    DEFAULT_MODEL,
    Machine,
    NormalizedConfig,
    load_machine_config,
)

__all__ = ["DEFAULT_MODEL", "Machine", "NormalizedConfig", "load_machine_config"]
