"""resource-lifecycle — resource-owning classes are closeable and closed
(copy of ``edl_tpu.analysis.checks.lifecycle``).

Pass 1 finds **resource classes**: a class that constructs a thread,
process, socket, shared-memory segment, or subprocess (the
``resource_calls`` list in layers.toml) and KEEPS it — the constructor
result is stored on ``self`` (directly, through a conditional
expression, through a ``X(...).start()`` builder chain, appended into a
``self`` container, or via a local later assigned to ``self``).  Such a
class must define a teardown method (``close``/``stop``/``shutdown``/
``cancel``) — a kept thread you cannot join is a leak by construction.
A resource that stays local to one method (started and joined in
``handle()``, say) is that method's business, not the class contract's.

Pass 2 audits every **instantiation site** of a resource class across
the project.  A site passes when ownership is visibly bounded:

- the call is the context expression of a ``with`` (directly or inside
  ``contextlib.closing(...)`` / ``enter_context``);
- the result is returned / yielded / produced by a ``lambda`` (a
  factory: the caller owns it);
- the result lands on ``self`` in a class that itself has a teardown
  method (ownership transfer: the audit moves to the owner's sites);
- the result is bound to a local that the same function either tears
  down in a ``finally:``, stores onto a closeable ``self``, or hands to
  the constructor of a project class with a teardown method (ownership
  handoff — e.g. a registrar wrapped into a pool handle);
- the line carries ``# lifecycle: long-lived(<reason>)`` — the explicit
  registry of process-lifetime singletons, reason mandatory.

Everything else — a local that leaks on the exception path, a bare
expression statement, a module-level instance without the annotation —
is a finding.  Resolution is name-based across the project (no type
inference), which is exactly as blunt as it sounds and in practice
right for this codebase's flat naming.
"""

from __future__ import annotations

import ast

from edl_tpu_torch.analysis.core import Finding, Project, SourceFile

_TEARDOWN_CALLS = {"close", "stop", "shutdown", "terminate", "kill",
                   "cancel"}
_CONTAINER_ADDS = {"append", "add", "appendleft", "insert"}


def _cfg(project: Project) -> tuple[set[str], set[str]]:
    spec = project.config.get("lifecycle") or {}
    calls = set(spec.get("resource_calls") or
                ["Thread", "Process", "SharedMemory", "socket",
                 "create_connection", "create_server", "Popen"])
    teardown = set(spec.get("teardown_methods") or
                   ["close", "stop", "shutdown", "cancel"])
    return calls, teardown


def _call_name(node: ast.Call) -> str | None:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _class_methods(cls: ast.ClassDef) -> set[str]:
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _has_teardown(cls: ast.ClassDef, teardown: set[str],
                  all_classes: dict[str, ast.ClassDef]) -> bool:
    seen: set[str] = set()
    stack = [cls]
    while stack:
        cur = stack.pop()
        if cur.name in seen:
            continue
        seen.add(cur.name)
        if _class_methods(cur) & teardown:
            return True
        for base in cur.bases:
            bname = base.id if isinstance(base, ast.Name) else (
                base.attr if isinstance(base, ast.Attribute) else None)
            if bname and bname in all_classes:
                stack.append(all_classes[bname])
    return False


def _binding(sf: SourceFile, call: ast.Call):
    """How the fresh instance is bound, unwrapping pass-through shapes.

    Returns one of: ("with",) ("factory",) ("self",) ("local", name,
    node) ("container-self",) (None, node) — node being the outermost
    expression the value flowed into (for context-specific rules)."""
    node: ast.AST = call
    parent = sf.parents.get(node)
    while True:
        # value-preserving expression wrappers
        if isinstance(parent, (ast.IfExp, ast.BoolOp, ast.NamedExpr)):
            node, parent = parent, sf.parents.get(parent)
            continue
        # contextlib.closing(X(...)) / stack.enter_context(X(...))
        if isinstance(parent, ast.Call) and _call_name(parent) in (
                "closing", "enter_context"):
            node, parent = parent, sf.parents.get(parent)
            continue
        # builder chain: X(...).start() returns the instance
        if isinstance(parent, ast.Attribute):
            gp = sf.parents.get(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                node, parent = gp, sf.parents.get(gp)
                continue
        break
    if isinstance(parent, ast.withitem):
        return ("with",)
    if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom,
                           ast.Lambda)):
        return ("factory",)
    if isinstance(parent, ast.Assign):
        for t in parent.targets:
            if _is_self_attr(t):
                return ("self",)
        for t in parent.targets:
            if isinstance(t, ast.Name):
                return ("local", t.id, parent)
    # self._things.append(X(...))
    if isinstance(parent, ast.Call) and isinstance(parent.func,
                                                   ast.Attribute) \
            and parent.func.attr in _CONTAINER_ADDS \
            and _is_self_attr(parent.func.value):
        return ("container-self",)
    return (None, node)


def _local_stored_on_self(sf: SourceFile, func: ast.AST, var: str) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == var \
                and any(_is_self_attr(t) for t in node.targets):
            return True
    return False


def _local_handed_to_owner(sf: SourceFile, func: ast.AST, var: str,
                           teardown: set[str],
                           all_classes: dict[str, ast.ClassDef]) -> bool:
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        cname = _call_name(node)
        owner = all_classes.get(cname) if cname else None
        if owner is None or not _has_teardown(owner, teardown, all_classes):
            continue
        if any(isinstance(a, ast.Name) and a.id == var for a in node.args):
            return True
    return False


def _finally_closes(sf: SourceFile, func: ast.AST, var: str) -> bool:
    for node in ast.walk(func):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for fin in node.finalbody:
            for sub in ast.walk(fin):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in _TEARDOWN_CALLS \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == var:
                    return True
    return False


def _find_resource_classes(project: Project, resource_calls: set[str]
                           ) -> dict[str, tuple[str, ast.ClassDef]]:
    """{class name: (path, node)} for classes that construct AND KEEP a
    raw resource (see module docstring for what 'keep' means)."""
    out: dict[str, tuple[str, ast.ClassDef]] = {}
    for path, sf in sorted(project.files.items()):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef) or node.name in out:
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Call)
                        and _call_name(sub) in resource_calls):
                    continue
                kept = False
                bind = _binding(sf, sub)
                if bind[0] in ("self", "container-self"):
                    kept = True
                elif bind[0] == "local":
                    func = sf.enclosing_function(sub)
                    kept = func is not None and _local_stored_on_self(
                        sf, func, bind[1])
                if kept and sf.enclosing_class(sub) is node:
                    out[node.name] = (path, node)
                    break
    return out


def check_lifecycle(project: Project):
    resource_calls, teardown = _cfg(project)
    classes = _find_resource_classes(project, resource_calls)

    all_classes: dict[str, ast.ClassDef] = {}
    for sf in project.files.values():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                all_classes.setdefault(node.name, node)

    # Pass 1: every keeping resource class defines a teardown method.
    for name, (path, node) in sorted(classes.items()):
        if _has_teardown(node, teardown, all_classes):
            continue
        yield Finding(
            "resource-lifecycle", path, node.lineno,
            f"class '{name}' keeps threads/sockets/shared memory on "
            f"self but defines no teardown method "
            f"({'/'.join(sorted(teardown))})")

    # Pass 2: instantiation sites of resource classes.
    for path, sf in sorted(project.files.items()):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = _call_name(node)
            if cname not in classes:
                continue
            encl = sf.enclosing_class(node)
            if encl is not None and encl.name == cname:
                continue  # a class's own methods may self-construct
            if _site_ok(sf, node, teardown, all_classes):
                continue
            yield Finding(
                "resource-lifecycle", sf.path, node.lineno,
                f"'{cname}' instantiated without bounded ownership — "
                "use a context manager, close it in a finally:, store "
                "it on a closeable owner, or register the site with "
                "'# lifecycle: long-lived(<reason>)'")


def _site_ok(sf: SourceFile, call: ast.Call, teardown: set[str],
             all_classes: dict[str, ast.ClassDef]) -> bool:
    # the annotation may sit at the end of the call line or on its own
    # line directly above (long reasons don't fit after the call)
    if sf.long_lived.get(call.lineno) is not None \
            or sf.long_lived.get(call.lineno - 1) is not None:
        return True
    bind = _binding(sf, call)
    if bind[0] in ("with", "factory"):
        return True
    if bind[0] in ("self", "container-self"):
        encl = sf.enclosing_class(call)
        return encl is not None and _has_teardown(encl, teardown,
                                                  all_classes)
    if bind[0] == "local":
        var = bind[1]
        func = sf.enclosing_function(call)
        if func is None:
            return False  # module-level: annotate or restructure
        if _finally_closes(sf, func, var):
            return True
        if _local_stored_on_self(sf, func, var):
            encl = sf.enclosing_class(call)
            return encl is not None and _has_teardown(encl, teardown,
                                                      all_classes)
        if _local_handed_to_owner(sf, func, var, teardown, all_classes):
            return True
    return False
