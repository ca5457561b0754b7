"""guarded-by — annotated shared state is only mutated under its lock
(copy of ``edl_tpu.analysis.checks.guarded_by``).

Annotation: put ``# guarded-by: _lock`` on the line where the field is
first assigned (conventionally in ``__init__``)::

    self._pending = 0          # guarded-by: _lock

From then on, every mutation of ``self._pending`` anywhere in that
class — assignment, augmented assignment, ``del``, subscript store, or
a call of a known mutating method (``append``/``pop``/``update``/...)
— must sit lexically inside ``with self._lock:`` (``Condition`` objects
count: ``with self._cond:`` takes the underlying lock).

Exemptions, each an explicit happens-before argument:

- ``__init__`` — construction precedes any concurrent access;
- methods whose ``def`` line carries ``# holds-lock: _lock`` — the
  documented contract that every caller already holds the lock;
- the annotation line itself.

The check is lexical and per-class: a ``with`` in an OUTER function
does not bless a mutation inside a nested ``def`` (the closure may run
on another thread after the lock is dropped — that is precisely the bug
class this exists for).  Reads are not checked; the annotation grammar
deliberately stays small enough to trust.
"""

from __future__ import annotations

import ast

from edl_tpu_torch.analysis.core import Finding, Project, SourceFile

_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse",
}


def check_guarded_by(project: Project):
    for path, sf in sorted(project.files.items()):
        if not sf.guarded_by:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                yield from _check_class(sf, node)


def _annotated_fields(sf: SourceFile, cls: ast.ClassDef) -> dict[str, str]:
    """{field name: lock name} from guarded-by comments inside `cls`
    whose line holds a ``self.<field> = ...`` (or ``: type = ...``)."""
    fields: dict[str, str] = {}
    for node in ast.walk(cls):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            name = _self_attr(t)
            if name is None:
                continue
            lock = sf.guarded_by.get(t.lineno)
            if lock is not None:
                fields[name] = lock
    return fields


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _check_class(sf: SourceFile, cls: ast.ClassDef):
    fields = _annotated_fields(sf, cls)
    if not fields:
        return
    for node in ast.walk(cls):
        for name, mutation_kind in _mutations(node):
            lock = fields.get(name)
            if lock is None:
                continue
            if _is_protected(sf, node, cls, lock):
                continue
            yield Finding(
                "guarded-by", sf.path, node.lineno,
                f"'self.{name}' is guarded by 'self.{lock}' but this "
                f"{mutation_kind} is outside 'with self.{lock}' "
                "(and not in __init__ or a '# holds-lock' method)")


def _mutations(node: ast.AST):
    """(field, kind) for mutations rooted at this single node."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _target_mutation(t, "assignment")
    elif isinstance(node, ast.AugAssign):
        yield from _target_mutation(node.target, "augmented assignment")
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            yield from _target_mutation(t, "del")
    elif isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            name = _self_attr(func.value)
            if name is not None:
                yield name, f".{func.attr}() call"


def _target_mutation(target: ast.expr, kind: str):
    name = _self_attr(target)
    if name is not None:
        yield name, kind
        return
    # self.field[...] = / del self.field[...]
    if isinstance(target, ast.Subscript):
        name = _self_attr(target.value)
        if name is not None:
            yield name, f"subscript {kind}"
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_mutation(elt, kind)


def _is_protected(sf: SourceFile, node: ast.AST, cls: ast.ClassDef,
                  lock: str) -> bool:
    func = None
    for anc in sf.ancestors(node):
        if isinstance(anc, ast.With):
            if func is None and any(
                    _self_attr(item.context_expr) == lock
                    for item in anc.items):
                return True
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if func is None:
                func = anc
                if anc.name == "__init__":
                    return True
                if sf.holds_lock.get(anc.lineno) == lock:
                    return True
            # keep walking: a method nested in a method never happens
            # here, but the enclosing CLASS decides when to stop
        elif isinstance(anc, ast.Lambda) and func is None:
            func = anc
        elif anc is cls:
            break
    return False
