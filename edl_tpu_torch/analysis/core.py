"""edl-lint core: file model, suppressions, import graph, runner (copy
of ``edl_tpu.analysis.core``; ``Project.load`` reads the port's own
layer map, ``edl_tpu_torch/analysis/layers.toml``).

Stdlib-only (the ``layering`` checker pins the whole package torch/numpy
free: a lint that needed the accelerator stack could not gate a
scheduler-node build).  Python 3.10 has no ``tomllib``, so the layer
map is read by :func:`load_toml_lite`, a parser for the small TOML
subset ``layers.toml`` actually uses (tables, string/number/bool
scalars, single-line string arrays).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field


# --------------------------------------------------------------------------
# toml-lite


def load_toml_lite(text: str) -> dict:
    """Parse the TOML subset used by ``layers.toml``: ``[a.b]`` tables,
    ``key = "str" | 123 | 1.5 | true | ["a", "b"]`` pairs, ``#`` comments.
    Raises ``ValueError`` on anything it does not understand — a silently
    half-read layer map would be a lint that lies."""
    root: dict = {}
    table = root
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ValueError(f"layers.toml:{lineno}: malformed table {line!r}")
            table = root
            for part in line[1:-1].strip().split("."):
                table = table.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            raise ValueError(f"layers.toml:{lineno}: expected key = value, got {line!r}")
        key, _, value = line.partition("=")
        table[key.strip()] = _toml_value(value.strip(), lineno)
    return root


def _toml_value(value: str, lineno: int):
    if value.startswith("["):
        if not value.endswith("]"):
            raise ValueError(f"layers.toml:{lineno}: arrays must be single-line")
        body = value[1:-1].strip()
        if not body:
            return []
        return [_toml_value(item.strip(), lineno)
                for item in _split_toml_array(body, lineno)]
    if value.startswith('"'):
        if not value.endswith('"') or len(value) < 2:
            raise ValueError(f"layers.toml:{lineno}: unterminated string {value!r}")
        return value[1:-1]
    if value in ("true", "false"):
        return value == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        raise ValueError(f"layers.toml:{lineno}: unsupported value {value!r}") from None


def _split_toml_array(body: str, lineno: int) -> list[str]:
    items, cur, in_str = [], [], False
    for ch in body:
        if ch == '"':
            in_str = not in_str
        if ch == "," and not in_str:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if in_str:
        raise ValueError(f"layers.toml:{lineno}: unterminated string in array")
    if cur:
        items.append("".join(cur))
    return [i.strip() for i in items if i.strip()]


# --------------------------------------------------------------------------
# findings + suppressions

# the directive grammar: 'disable=' then comma-joined check(reason)
# items (the literal text is not written
# out here because this comment would itself match the regex)
_SUPPRESS_RE = re.compile(r"#\s*edl-lint:\s*disable=(.+)$")
_SUPPRESS_ITEM_RE = re.compile(r"\s*([a-z0-9-]+)\(([^()]+)\)\s*$")
# '# guarded-by: _lock'   (field annotation — see checks/guarded_by.py)
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
# '# holds-lock: _lock'   (method called only with the lock already held)
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_]\w*)")
# '# lifecycle: long-lived(reason)' (registered long-lived singleton site)
_LONG_LIVED_RE = re.compile(r"#\s*lifecycle:\s*long-lived\(([^()]+)\)")


@dataclass(frozen=True)
class Finding:
    check: str
    path: str          # repo-relative, '/'-separated
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass(frozen=True)
class Suppression:
    check: str
    reason: str
    path: str
    line: int


class LintError(ValueError):
    """Malformed lint directive (e.g. a suppression without a reason)."""


def _parse_suppressions(path: str, line: int, comment: str) -> list[Suppression]:
    m = _SUPPRESS_RE.search(comment)
    if not m:
        return []
    out = []
    # split on commas OUTSIDE parens: reasons may contain commas
    depth, cur, items = 0, [], []
    for ch in m.group(1):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    items.append("".join(cur))
    for item in items:
        im = _SUPPRESS_ITEM_RE.match(item)
        if not im:
            raise LintError(
                f"{path}:{line}: malformed suppression {item.strip()!r} — "
                "the syntax is '# edl-lint: disable=<check>(<reason>)' and "
                "the reason is mandatory")
        out.append(Suppression(im.group(1), im.group(2).strip(), path, line))
    return out


# --------------------------------------------------------------------------
# source files


class SourceFile:
    """One parsed module: AST + per-line comments, suppressions and
    lint annotations (extracted with ``tokenize`` so ``#`` inside string
    literals can't fake a directive)."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.comments: dict[int, str] = {}
        self.suppressions: dict[int, list[Suppression]] = {}
        self.guarded_by: dict[int, str] = {}      # line -> lock name
        self.holds_lock: dict[int, str] = {}      # line -> lock name
        self.long_lived: dict[int, str] = {}      # line -> reason
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            self.comments[line] = tok.string
            sups = _parse_suppressions(path, line, tok.string)
            if sups:
                self.suppressions.setdefault(line, []).extend(sups)
            for regex, store in ((_GUARDED_RE, self.guarded_by),
                                 (_HOLDS_RE, self.holds_lock),
                                 (_LONG_LIVED_RE, self.long_lived)):
                m = regex.search(tok.string)
                if m:
                    store[line] = m.group(1).strip()
        # parent links: checkers walk from a node up to its enclosing
        # with/function/class without re-deriving scope per check
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def enclosing_class(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None


# --------------------------------------------------------------------------
# project model


def _is_type_checking_guard(node: ast.AST) -> bool:
    if not isinstance(node, ast.If):
        return False
    test = node.test
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or \
        (isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")


@dataclass(frozen=True)
class ImportEdge:
    module: str        # absolute dotted module name as imported
    line: int
    top_level: bool    # module-body import (executes at import time)


class Project:
    """The lint subject: every ``.py`` under the configured paths, plus
    the import graph (import-time edges only — a function-scoped import
    is a deliberate deferral and does not violate import-time layering)."""

    def __init__(self, root: str, config: dict):
        self.root = os.path.abspath(root)
        self.config = config
        self.files: dict[str, SourceFile] = {}
        self.errors: list[Finding] = []
        paths = (config.get("lint") or {}).get("paths") or ["edl_tpu_torch"]
        for rel in paths:
            self._collect(os.path.join(self.root, rel))
        # module name -> repo-relative path, for import-graph resolution
        self.modules: dict[str, str] = {}
        for path in self.files:
            name = path[:-3].replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self.modules[name] = path
        self.imports: dict[str, list[ImportEdge]] = {
            path: self._imports_of(sf) for path, sf in self.files.items()}

    @classmethod
    def load(cls, root: str) -> "Project":
        cfg_path = os.path.join(root, "edl_tpu_torch", "analysis", "layers.toml")
        with open(cfg_path, encoding="utf-8") as f:
            config = load_toml_lite(f.read())
        return cls(root, config)

    def _collect(self, base: str) -> None:
        if os.path.isfile(base):
            self._add(base)
            return
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for name in sorted(filenames):
                if name.endswith(".py"):
                    self._add(os.path.join(dirpath, name))

    def _add(self, abspath: str) -> None:
        rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
        with open(abspath, encoding="utf-8") as f:
            text = f.read()
        try:
            self.files[rel] = SourceFile(rel, text)
        except SyntaxError as exc:
            self.errors.append(Finding(
                "parse", rel, exc.lineno or 0, f"syntax error: {exc.msg}"))
        except LintError as exc:
            self.errors.append(Finding("suppression", rel, 0, str(exc)))

    # -- import graph -------------------------------------------------------

    def _imports_of(self, sf: SourceFile) -> list[ImportEdge]:
        pkg_parts = sf.path[:-3].split("/")
        if pkg_parts[-1] == "__init__":
            pkg_parts = pkg_parts[:-1]
        edges: list[ImportEdge] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                names = [(alias.name, None) for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    prefix = ".".join(base + ([node.module] if node.module
                                              else []))
                else:
                    prefix = node.module or ""
                names = [(prefix, alias.name) for alias in node.names]
            else:
                continue
            top = self._is_import_time(sf, node)
            for module, attr in names:
                edges.append(ImportEdge(module, node.lineno, top))
                # 'from pkg import sub' may bind a submodule: record the
                # joined name too when it resolves to a project module
                if attr and f"{module}.{attr}" in getattr(self, "modules", {}):
                    edges.append(ImportEdge(f"{module}.{attr}", node.lineno,
                                            top))
        return edges

    def _is_import_time(self, sf: SourceFile, node: ast.AST) -> bool:
        """Module-body import (incl. inside try/if) but not inside a
        function and not under ``if TYPE_CHECKING:``."""
        for anc in sf.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            if _is_type_checking_guard(anc):
                return False
        return True

    def import_time_deps(self, path: str) -> list[tuple[str, ImportEdge]]:
        """(resolved target, edge) for every import-time edge of `path`.
        Importing ``a.b.c`` also executes ``a`` and ``a.b`` — ancestor
        package ``__init__``s are included as implicit targets, because
        a torch import hiding in a package ``__init__`` breaks the layer
        contract exactly as hard as a direct one."""
        out = []
        for edge in self.imports.get(path, ()):
            if not edge.top_level:
                continue
            parts = edge.module.split(".")
            for i in range(1, len(parts) + 1):
                prefix = ".".join(parts[:i])
                target = self.modules.get(prefix)
                if target is not None and target != path:
                    out.append((target, edge))
            if edge.module.split(".")[0] not in ("edl_tpu_torch",):
                out.append((edge.module, edge))   # external dep, unresolved
        return out


# --------------------------------------------------------------------------
# runner


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[tuple[Finding, Suppression]] = field(default_factory=list)
    suppressions: list[Suppression] = field(default_factory=list)
    checks_run: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checks": self.checks_run,
            "findings": [vars(f) for f in self.findings],
            "suppressed": [{**vars(f), "reason": s.reason}
                           for f, s in self.suppressed],
            "suppressions": [vars(s) for s in self.suppressions],
        }


def run_lint(root: str, checks: list[str] | None = None) -> LintResult:
    """Run every registered checker over the project at `root`.

    A finding is suppressed iff its line carries a matching
    ``# edl-lint: disable=<check>(<reason>)``; suppressions that match
    no finding are reported as ``unused-suppression`` findings so the
    inventory can never rot."""
    from edl_tpu_torch.analysis.checks import CHECKS
    project = Project.load(root)
    result = LintResult()
    result.findings.extend(project.errors)
    selected = {name: fn for name, fn in CHECKS.items()
                if checks is None or name in checks}
    result.checks_run = sorted(selected)
    raw: list[Finding] = []
    seen: set[Finding] = set()
    for name in sorted(selected):
        for f in selected[name](project):
            # one finding per (check, site, message): a forbidden module
            # reachable over several import paths is one defect
            if f not in seen:
                seen.add(f)
                raw.append(f)

    for sf in project.files.values():
        for sups in sf.suppressions.values():
            result.suppressions.extend(sups)
    used: set[tuple[str, int, str]] = set()
    for f in raw:
        sups = project.files.get(f.path)
        match = None
        if sups is not None:
            for s in sups.suppressions.get(f.line, []):
                if s.check == f.check:
                    match = s
                    break
        if match is not None:
            result.suppressed.append((f, match))
            used.add((match.path, match.line, match.check))
        else:
            result.findings.append(f)
    for s in result.suppressions:
        if (s.path, s.line, s.check) not in used:
            result.findings.append(Finding(
                "unused-suppression", s.path, s.line,
                f"suppression for '{s.check}' matches no finding — "
                "delete it (reason was: " + s.reason + ")"))
    result.findings.sort(key=lambda f: (f.path, f.line, f.check))
    return result
