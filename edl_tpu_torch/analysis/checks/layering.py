"""layering — the declared layer map, enforced on import-time edges
(copy of ``edl_tpu.analysis.checks.layering``).

For every file in a declared layer, walk the project-internal
import-time graph (BFS) and flag any path that reaches a forbidden
module.  The finding names the whole chain — ``coord/collector.py ->
edl_tpu_torch.utils.timeline -> torch`` — because the violation is almost never
in the file you have open; it is two hops down in a helper that grew a
convenience import.

Import-time means module-body edges only (including under ``try:`` — a
guarded ``import torch`` still executes torch when it is installed, which
is exactly when the layer contract matters).  Function-scoped imports
and ``if TYPE_CHECKING:`` blocks are deliberate deferrals and exempt.
Importing ``a.b.c`` also executes ``a/__init__`` and ``a.b/__init__``,
so ancestor packages are implicit edges (core.Project handles this).
"""

from __future__ import annotations

from edl_tpu_torch.analysis.core import Finding, Project


def _forbidden_match(module: str, forbidden: list[str]) -> str | None:
    for ban in forbidden:
        if module == ban or module.startswith(ban + "."):
            return ban
    return None


def _module_name(project: Project, target: str) -> str:
    """Dotted module name of a dep target (project path or external)."""
    if target in project.files:
        name = target[:-3].replace("/", ".")
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        return name
    return target


def check_layering(project: Project):
    layers = project.config.get("layers") or {}
    for layer_name, spec in sorted(layers.items()):
        packages = spec.get("packages") or []
        forbidden = spec.get("forbidden") or []
        members = [path for path in project.files
                   if any(path == p or path.startswith(p + "/")
                          for p in packages)]
        for path in sorted(members):
            yield from _check_file(project, layer_name, path, forbidden)


def _check_file(project: Project, layer: str, path: str,
                forbidden: list[str]):
    seen: set[str] = {path}
    queue: list[str] = [path]
    via: dict[str, tuple[str, object]] = {}   # node -> (parent, edge)
    while queue:
        cur = queue.pop(0)
        for target, edge in project.import_time_deps(cur):
            ban = _forbidden_match(_module_name(project, target), forbidden)
            if ban is not None:
                yield Finding(
                    "layering", path, _root_line(via, path, cur, edge),
                    f"layer '{layer}' must not import '{ban}' "
                    f"(chain: {_chain(via, path, cur, edge, target)})")
            elif target in project.files and target not in seen:
                seen.add(target)
                via[target] = (cur, edge)
                queue.append(target)


def _root_line(via: dict, root: str, cur: str, edge) -> int:
    """The ROOT file's import line that starts the chain (that is the
    line the suppression must sit on, and the line a fix edits)."""
    if cur == root:
        return edge.line
    node = cur
    while via[node][0] != root:
        node = via[node][0]
    return via[node][1].line


def _chain(via: dict, root: str, cur: str, edge, target: str) -> str:
    hops = [f"{target} (line {edge.line} of {cur})"]
    node = cur
    while node != root:
        parent, pedge = via[node]
        hops.append(f"{node} (line {pedge.line} of {parent})")
        node = parent
    hops.append(root)
    return " <- ".join(hops)
