"""Model builds (counterpart of ``gordo_tpu/builder``): one machine
(``build_model``, ``provide_saved_model``) or a whole project through the
fleet engine (``build_project``)."""

from gordo_tpu_torch.builder.build_model import (  # noqa: F401
    assemble_metadata,
    build_model,
    calculate_model_key,
    provide_saved_model,
)
from gordo_tpu_torch.builder.fleet_build import (  # noqa: F401
    ProjectBuildResult,
    build_project,
)
