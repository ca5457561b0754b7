"""env-registry — source <-> declaration <-> documentation knob parity.

Knobs parsed ad hoc across entry points drift away from their doc page;
this checker (copy of ``edl_tpu.analysis.checks.env_registry``) makes
the drift impossible:

1. every ``os.environ[...]`` / ``os.environ.get`` / ``os.getenv`` /
   ``in os.environ`` READ of an ``EDL_TPU_*`` name must live in
   ``utils/config.py`` — everything else goes through the typed helpers
   (``env_str``/``env_int``/``env_float``/``env_flag``/``env_present``)
   or a ``field(env=...)`` declaration;
2. every referenced name must be declared in the central ``ENV_VARS``
   table in ``utils/config.py``;
3. every declared name must have a row in the ``[env] doc`` file's
   reference table (``| `EDL_TPU_X` | ... |``) — and every doc row must
   be a declared name (dead rows flagged);
4. a declared name nothing reads any more is a dead declaration.

Environment WRITES (``os.environ["EDL_TPU_X"] = ...``, ``setdefault``,
``pop``) are launcher/demo business and allowed anywhere — but the name
written must still be declared, so a knob cannot exist only as a write.
"""

from __future__ import annotations

import ast
import os
import re

from edl_tpu_torch.analysis.core import Finding, Project

_READ_METHODS = {"get", "__getitem__"}
_WRITE_METHODS = {"setdefault", "pop"}
_HELPERS = {"env_str", "env_int", "env_float", "env_flag", "env_present"}


def _env_cfg(project: Project) -> dict:
    return project.config.get("env") or {}


def _name_re(prefix: str) -> re.Pattern:
    return re.compile(re.escape(prefix) + r"[A-Z0-9_]+\Z")


def _is_os_environ(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def parse_env_vars_table(project: Project, config_path: str) -> dict[str, int]:
    """``ENV_VARS`` dict literal in utils/config.py -> {name: line}."""
    sf = project.files.get(config_path)
    if sf is None:
        return {}
    for node in ast.walk(sf.tree):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == "ENV_VARS"):
            continue
        if not isinstance(value, ast.Dict):
            return {}
        out = {}
        for key in value.keys:
            name = _const_str(key)
            if name is not None:
                out[name] = key.lineno
        return out
    return {}


def parse_doc_rows(root: str, doc_rel: str, prefix: str) -> dict[str, int]:
    """Markdown table rows ``| `EDL_TPU_X` | ... |`` -> {name: line}."""
    path = os.path.join(root, doc_rel)
    row_re = re.compile(r"^\|\s*`(" + re.escape(prefix) + r"[A-Z0-9_]+)`")
    rows: dict[str, int] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                m = row_re.match(line)
                if m:
                    rows.setdefault(m.group(1), lineno)
    except OSError:
        pass
    return rows


def _collect_refs(project: Project, prefix: str):
    """Yield (path, line, name, kind) for every EDL_TPU_* reference.

    kind: 'raw-read' | 'raw-write' | 'helper' | 'field' | 'mention'
    """
    name_re = _name_re(prefix)
    for path, sf in sorted(project.files.items()):
        for node in ast.walk(sf.tree):
            # os.environ[NAME] — read unless it is an assignment target
            if isinstance(node, ast.Subscript) and _is_os_environ(node.value):
                name = _const_str(node.slice)
                if name and name_re.match(name):
                    store = isinstance(node.ctx, (ast.Store, ast.Del))
                    yield (path, node.lineno, name,
                           "raw-write" if store else "raw-read")
            # os.environ.get/ setdefault/ pop, os.getenv
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and _is_os_environ(func.value) \
                        and func.attr in (_READ_METHODS | _WRITE_METHODS):
                    name = _const_str(node.args[0]) if node.args else None
                    if name and name_re.match(name):
                        kind = ("raw-read" if func.attr in _READ_METHODS
                                else "raw-write")
                        yield (path, node.lineno, name, kind)
                elif isinstance(func, ast.Attribute) \
                        and func.attr == "getenv" \
                        and isinstance(func.value, ast.Name) \
                        and func.value.id == "os":
                    name = _const_str(node.args[0]) if node.args else None
                    if name and name_re.match(name):
                        yield (path, node.lineno, name, "raw-read")
                elif (isinstance(func, ast.Name) and func.id in _HELPERS) \
                        or (isinstance(func, ast.Attribute)
                            and func.attr in _HELPERS):
                    name = _const_str(node.args[0]) if node.args else None
                    if name and name_re.match(name):
                        yield (path, node.lineno, name, "helper")
                elif (isinstance(func, ast.Name) and func.id == "field") \
                        or (isinstance(func, ast.Attribute)
                            and func.attr == "field"):
                    for kw in node.keywords:
                        if kw.arg != "env":
                            continue
                        vals = [kw.value] if not isinstance(
                            kw.value, ast.Tuple) else list(kw.value.elts)
                        for v in vals:
                            name = _const_str(v)
                            if name and name_re.match(name):
                                yield (path, v.lineno, name, "field")
            # 'NAME in os.environ' membership read
            elif isinstance(node, ast.Compare) \
                    and len(node.comparators) == 1 \
                    and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                    and _is_os_environ(node.comparators[0]):
                name = _const_str(node.left)
                if name and name_re.match(name):
                    yield (path, node.lineno, name, "raw-read")
            # bare full-name string constants (env-forward lists etc.):
            # a mention must be declared, but does not count as a read
            elif isinstance(node, ast.Constant):
                name = _const_str(node)
                if name and name_re.match(name):
                    yield (path, node.lineno, name, "mention")


def check_env_registry(project: Project):
    cfg = _env_cfg(project)
    prefix = cfg.get("prefix", "EDL_TPU_")
    config_path = cfg.get("config_module", "edl_tpu_torch/utils/config.py")
    doc_rel = cfg.get("doc", "doc/usage_torch.md")

    declared = parse_env_vars_table(project, config_path)
    if not declared and config_path in project.files:
        yield Finding("env-registry", config_path, 1,
                      "central ENV_VARS declaration table not found "
                      "(expected a dict literal named ENV_VARS)")
        return
    doc_rows = parse_doc_rows(project.root, doc_rel, prefix)

    reads: set[str] = set()
    referenced: set[str] = set()
    seen_undeclared: set[tuple[str, int, str]] = set()
    for path, line, name, kind in _collect_refs(project, prefix):
        referenced.add(name)
        if kind in ("raw-read", "helper", "field"):
            reads.add(name)
        if kind == "raw-read" and path != config_path:
            yield Finding(
                "env-registry", path, line,
                f"direct environment read of '{name}' — go through "
                "utils/config (env_str/env_int/env_float/env_flag/"
                "env_present or field(env=...))")
        if name not in declared and (path, line, name) not in seen_undeclared:
            seen_undeclared.add((path, line, name))
            yield Finding(
                "env-registry", path, line,
                f"'{name}' is not declared in the ENV_VARS table in "
                "utils/config.py")

    for name, line in sorted(declared.items()):
        if name not in doc_rows:
            yield Finding(
                "env-registry", config_path, line,
                f"declared knob '{name}' has no row in the {doc_rel} "
                "env reference table")
        if name not in reads:
            yield Finding(
                "env-registry", config_path, line,
                f"declared knob '{name}' is never read anywhere — "
                "dead declaration (delete it and its doc row)")

    doc_path = doc_rel.replace(os.sep, "/")
    for name, line in sorted(doc_rows.items()):
        if name not in declared:
            yield Finding(
                "env-registry", doc_path, line,
                f"doc row for '{name}' matches no declared knob — "
                "dead doc row")
