"""edl-lint and lockgraph: the analysis plane of the port (copy of
``edl_tpu.analysis``).

Two planes:

- **edl-lint** (``python -m edl_tpu_torch.analysis lint``): a stdlib-only
  AST framework (`core.py`) with five checkers (`checks/`), run over the
  port against its own layer map (`layers.toml`):

  * ``layering``            — the declared layer map: coord/scaler/
    analysis/obs never import torch/numpy/train, data never imports
    distill; violations name the full import chain.
  * ``env-registry``        — every ``EDL_TPU_*`` env read goes through
    the central declaration table in `utils/config.py` AND has a row in
    ``doc/usage_torch.md`` (flags undocumented knobs and dead doc rows
    both ways).
  * ``guarded-by``          — fields annotated ``# guarded-by: _lock``
    are only mutated under ``with self._lock``.
  * ``resource-lifecycle``  — classes that create threads / shared
    memory / sockets define a teardown method, and instantiation sites
    are context-managed, finally-closed, or registered long-lived.
  * ``sim-determinism``     — wall clocks and unseeded RNGs are banned
    from the scaler simulator, the fleet simulator and everything they
    import.

  Inline suppressions: ``# edl-lint: disable=<check>(<reason>)``; the
  reason is mandatory, unused suppressions are themselves findings.
  Both packages' checkers give the same findings on the same project.

- **lockgraph** (`lockgraph.py`): a ``threading`` instrumentation
  harness that records per-thread lock-acquisition orderings, builds the
  global lock-order graph, and fails on cycles (potential ABBA deadlock)
  with both acquisition stacks printed. The chaos soak runs it by
  default.

This package is pure stdlib: importable without torch, jax or numpy.
"""

from edl_tpu_torch.analysis.core import Finding, LintResult, Project, run_lint

__all__ = ["Finding", "LintResult", "Project", "run_lint"]
