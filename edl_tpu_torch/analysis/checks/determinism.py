"""sim-determinism — wall clocks and unseeded RNGs banned from the sim
(copy of ``edl_tpu.analysis.checks.determinism``).

The scaler bench contract is seeded-exact: the same seed replays the
same decision trace bit-for-bit, which is what makes policy
tournaments and CI convergence gates meaningful; one stray
``time.time()`` in a policy helper would break that silently.  This
check makes the contract structural over the files
named in ``[determinism] files`` (layers.toml) **plus every project
module they import, transitively** (function-scoped imports included —
a deferred import is still executed by the sim).

Banned:

- ``time.time/time_ns/monotonic/monotonic_ns/perf_counter[_ns]`` —
  the sim runs on a virtual clock that ticks in whole decisions;
- ``datetime.now/utcnow/today`` and ``date.today``;
- module-level ``random.<fn>()`` (the global RNG — including
  ``random.seed``: seeding global state is how two sims contaminate
  each other); ``random.Random(seed)`` with an argument is the blessed
  form, argless ``random.Random()`` falls back to OS entropy and is
  banned;
- ``np.random.<fn>()`` except ``default_rng/RandomState/Generator/
  SeedSequence`` called WITH a seed argument (the scaler layer is
  numpy-free anyway — the rule exists so the checker generalizes to
  any files listed in layers.toml).
"""

from __future__ import annotations

import ast

from edl_tpu_torch.analysis.core import Finding, Project

_TIME_BANNED = {"time", "time_ns", "monotonic", "monotonic_ns",
                "perf_counter", "perf_counter_ns"}
_DATETIME_BANNED = {"now", "utcnow", "today"}
_NP_RANDOM_SEEDED_OK = {"default_rng", "RandomState", "Generator",
                        "SeedSequence"}
_RANDOM_CLASSES = {"Random"}


def _scope_files(project: Project) -> set[str]:
    spec = project.config.get("determinism") or {}
    roots = [f.replace("\\", "/") for f in (spec.get("files") or [])]
    scope: set[str] = set()
    queue = [f for f in roots if f in project.files]
    while queue:
        path = queue.pop()
        if path in scope:
            continue
        scope.add(path)
        for edge in project.imports.get(path, ()):
            if not edge.top_level:
                continue   # a deferred import runs code the sim never calls
            # exact module only — executing an ancestor package __init__
            # merely DEFINES modules; the sim does not call into them
            target = project.modules.get(edge.module)
            if target and target not in scope:
                queue.append(target)
    return scope


def check_determinism(project: Project):
    for path in sorted(_scope_files(project)):
        sf = project.files[path]
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = _banned_call(node)
            if msg:
                yield Finding(
                    "sim-determinism", path, node.lineno,
                    msg + " — the sim contract is seeded-exact "
                    "(virtual clock + explicit seeded RNGs only)")


def _banned_call(node: ast.Call) -> str | None:
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    owner = func.value
    # time.<fn>
    if isinstance(owner, ast.Name) and owner.id == "time" \
            and func.attr in _TIME_BANNED:
        return f"wall-clock call time.{func.attr}()"
    # datetime.now / datetime.datetime.now / date.today
    if func.attr in _DATETIME_BANNED:
        names = _dotted(owner)
        if names and names[0] in ("datetime", "date"):
            return f"wall-clock call {'.'.join(names)}.{func.attr}()"
    # random.<fn> on the MODULE (global RNG); random.Random(seed) is ok
    if isinstance(owner, ast.Name) and owner.id == "random":
        if func.attr in _RANDOM_CLASSES:
            if not node.args and not node.keywords:
                return "argless random.Random() (OS-entropy seed)"
            return None
        if func.attr in ("SystemRandom",):
            return "random.SystemRandom() (OS entropy)"
        return f"global-RNG call random.{func.attr}()"
    # np.random.<fn> / numpy.random.<fn>
    names = _dotted(owner)
    if len(names) == 2 and names[0] in ("np", "numpy") \
            and names[1] == "random":
        if func.attr in _NP_RANDOM_SEEDED_OK:
            if node.args or node.keywords:
                return None
            return f"unseeded np.random.{func.attr}()"
        return f"global-RNG call np.random.{func.attr}()"
    return None


def _dotted(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []
