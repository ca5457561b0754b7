"""Checker registry: name -> callable(Project) -> Iterable[Finding]
(copy of ``edl_tpu.analysis.checks``).

Checker names are what suppressions reference
(``# edl-lint: disable=layering(...)``), so they are part of the lint's
public contract — rename one and every suppression for it goes stale
(and the ``unused-suppression`` check will say so).
"""

from edl_tpu_torch.analysis.checks.layering import check_layering
from edl_tpu_torch.analysis.checks.env_registry import check_env_registry
from edl_tpu_torch.analysis.checks.guarded_by import check_guarded_by
from edl_tpu_torch.analysis.checks.lifecycle import check_lifecycle
from edl_tpu_torch.analysis.checks.determinism import check_determinism

CHECKS = {
    "layering": check_layering,
    "env-registry": check_env_registry,
    "guarded-by": check_guarded_by,
    "resource-lifecycle": check_lifecycle,
    "sim-determinism": check_determinism,
}

__all__ = ["CHECKS"]
