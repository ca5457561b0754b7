"""The port's edl-lint (analysis/core.py, analysis/checks/,
analysis/__main__.py) against the JAX package's.

Each synthetic project of the JAX package's lint tests goes through both
packages' checkers and suppression accounting and gives the same findings
(check, path, line, message); so does the port's own tree under a layer
map whose doc table is the JAX package's. The toml-lite reader gives the
same tables and refuses the same text. The port lints clean against its
own map (every suppression with its reason), ``lint --json`` writes the
machine-readable result, and the lint half imports no torch, numpy or
jax.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from edl_tpu_torch.analysis import Finding, LintResult, Project, run_lint
from edl_tpu_torch.analysis.checks import CHECKS
from edl_tpu_torch.analysis.core import load_toml_lite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LAYER_CFG = {"layers": {"pure": {"packages": ["pkg/pure"],
                                  "forbidden": ["numpy"]}}}
_ENV_CFG = {"env": {"config_module": "pkg/config.py", "doc": "doc.md",
                    "prefix": "EDL_TPU_"}}
_DET_CFG = {"determinism": {"files": ["pkg/sim.py"]}}
_CONFIG_WITH = """\
    ENV_VARS = {"EDL_TPU_GOOD": "a documented knob"}
    import os
    def env_str(name, default=None):
        return os.environ.get(name, default)
"""
_GUARDED_BAD = """\
    import threading
    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0   # guarded-by: _lock
        def bump(self):
            self._count += 1
"""
_GUARDED_GOOD = """\
    import threading
    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0   # guarded-by: _lock
            self._items = []  # guarded-by: _lock
        def bump(self):
            with self._lock:
                self._count += 1
                self._items.append(1)
        def _bump_locked(self):  # holds-lock: _lock
            self._count += 1
"""
_INIT = {"pkg/__init__.py": "", "pkg/pure/__init__.py": ""}

# (files, config, doc.md text or None), named as the JAX package's cases
PROJECTS = {
    "layering-direct": ({**_INIT, "pkg/pure/mod.py": "import numpy as np\n"},
                        _LAYER_CFG, None),
    "layering-transitive": ({**_INIT, "pkg/pure/mod.py":
                             "from pkg.helper import x\n",
                             "pkg/helper.py": "import numpy\nx = 1\n"},
                            _LAYER_CFG, None),
    "layering-deferred": ({**_INIT, "pkg/pure/mod.py": """\
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            import numpy
        def f():
            import numpy as np
            return np
    """}, _LAYER_CFG, None),
    "env-direct-read": ({"pkg/__init__.py": "", "pkg/config.py": _CONFIG_WITH,
                         "pkg/user.py":
                         'import os\nv = os.environ["EDL_TPU_GOOD"]\n'},
                        _ENV_CFG, "| `EDL_TPU_GOOD` | ok |\n"),
    "env-undeclared-undocumented-dead-row": ({
        "pkg/__init__.py": "",
        "pkg/config.py": _CONFIG_WITH.replace(
            '{"EDL_TPU_GOOD": "a documented knob"}',
            '{"EDL_TPU_GOOD": "ok", "EDL_TPU_UNDOC": "no doc row"}'),
        "pkg/user.py": """\
            from pkg.config import env_str
            a = env_str("EDL_TPU_GOOD")
            b = env_str("EDL_TPU_UNDOC")
            c = env_str("EDL_TPU_MYSTERY")
        """}, _ENV_CFG,
        "| `EDL_TPU_GOOD` | ok |\n| `EDL_TPU_GONE` | dead row |\n"),
    "env-dead-declaration": ({
        "pkg/__init__.py": "",
        "pkg/config.py": _CONFIG_WITH.replace(
            '{"EDL_TPU_GOOD": "a documented knob"}',
            '{"EDL_TPU_GOOD": "ok", "EDL_TPU_UNREAD": "nobody reads"}'),
        "pkg/user.py": 'from pkg.config import env_str\n'
                       'a = env_str("EDL_TPU_GOOD")\n'}, _ENV_CFG,
        "| `EDL_TPU_GOOD` | ok |\n| `EDL_TPU_UNREAD` | doc |\n"),
    "env-clean": ({"pkg/__init__.py": "", "pkg/config.py": _CONFIG_WITH,
                   "pkg/user.py": 'from pkg.config import env_str\n'
                                  'a = env_str("EDL_TPU_GOOD")\n'},
                  _ENV_CFG, "| `EDL_TPU_GOOD` | ok |\n"),
    "env-fields-and-writes": ({
        "pkg/__init__.py": "",
        "pkg/config.py": _CONFIG_WITH.replace(
            '{"EDL_TPU_GOOD": "a documented knob"}',
            '{"EDL_TPU_GOOD": "ok", "EDL_TPU_F": "field", '
            '"EDL_TPU_W": "written only"}'),
        "pkg/user.py": """\
            import os
            from pkg import config
            from pkg.config import field
            x: int = field(1, env="EDL_TPU_F")
            os.environ["EDL_TPU_W"] = "1"
            os.environ.setdefault("EDL_TPU_UNDECLARED_W", "1")
            y = config.env_str("EDL_TPU_GOOD")
            z = os.getenv("EDL_TPU_GOOD")
            w = "EDL_TPU_GOOD" in os.environ
        """}, _ENV_CFG,
        "| `EDL_TPU_GOOD` | ok |\n| `EDL_TPU_F` | f |\n| `EDL_TPU_W` | w |\n"),
    "guarded-unlocked": ({"pkg/__init__.py": "", "pkg/m.py": _GUARDED_BAD},
                         {}, None),
    "guarded-clean": ({"pkg/__init__.py": "", "pkg/m.py": _GUARDED_GOOD},
                      {}, None),
    "guarded-closure": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0   # guarded-by: _lock
            def go(self):
                with self._lock:
                    def work():
                        self._n += 1
                    return work
    """}, {}, None),
    "guarded-method-call": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: _lock
            def add(self, x):
                self._items.append(x)
    """}, {}, None),
    "lifecycle-no-teardown": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class Keeper:
            def __init__(self):
                self._t = threading.Thread(target=lambda: None)
    """}, {}, None),
    "lifecycle-method-local": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class Scoped:
            def work(self):
                t = threading.Thread(target=lambda: None)
                t.start()
                t.join()
    """}, {}, None),
    "lifecycle-leaky-site": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class Res:
            def __init__(self):
                self._t = threading.Thread(target=lambda: None)
            def close(self):
                pass
        def leak():
            r = Res()          # no finally, no owner: finding
            return 1
        def ok_with():
            with Res() as r:
                return r
        def ok_finally():
            r = Res()
            try:
                return 1
            finally:
                r.close()
        def ok_factory():
            return Res()
        # lifecycle: long-lived(process singleton for the test)
        GLOBAL = Res()
    """}, {}, None),
    "lifecycle-handoff": ({"pkg/__init__.py": "", "pkg/m.py": """\
        import threading
        class Res:
            def __init__(self):
                self._t = threading.Thread(target=lambda: None)
            def close(self):
                pass
        class Owner:
            def __init__(self, res):
                self._res = res
            def close(self):
                self._res.close()
        def make():
            r = Res()
            return Owner(r)
    """}, {}, None),
    "determinism-transitive": ({"pkg/__init__.py": "",
                                "pkg/sim.py": "from pkg.helper import now\n",
                                "pkg/helper.py": """\
        import time, random
        def now():
            return time.time() + random.random()
    """}, _DET_CFG, None),
    "determinism-clean": ({"pkg/__init__.py": "", "pkg/sim.py": """\
        import random
        rng = random.Random(1234)
        def tick(clock):
            return clock() + rng.random()
    """}, _DET_CFG, None),
    "determinism-argless-random": ({"pkg/__init__.py": "", "pkg/sim.py":
                                    "import random\nrng = random.Random()\n"},
                                   _DET_CFG, None),
    "suppression-honored": ({**_INIT, "pkg/pure/mod.py":
                             "import numpy  # edl-lint: disable=layering("
                             "numpy needed for the fixture)\n"},
                            _LAYER_CFG, None),
    "suppression-reason-missing": ({**_INIT, "pkg/pure/mod.py":
                                    "import numpy  # edl-lint: "
                                    "disable=layering\n"}, _LAYER_CFG, None),
    "suppression-unused": ({**_INIT, "pkg/pure/mod.py":
                            "x = 1  # edl-lint: disable=layering(stale "
                            "reason)\n"}, _LAYER_CFG, None),
    "suppression-wrong-check": ({**_INIT, "pkg/pure/mod.py":
                                 "import numpy  # edl-lint: "
                                 "disable=guarded-by(wrong)\n"},
                                _LAYER_CFG, None),
    "syntax-error": ({"pkg/__init__.py": "", "pkg/bad.py": "def f(:\n"},
                     {}, None),
}


def _make(tmp_path, files, config, doc):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    if doc is not None:
        (tmp_path / "doc.md").write_text(doc)
    config = dict(config)
    config.setdefault("lint", {"paths": sorted(
        {rel.split("/")[0] for rel in files if rel.endswith(".py")})})
    return config


def _account(project, checks, finding_cls, result_cls):
    """run_lint's suppression accounting over an in-memory Project."""
    result = result_cls()
    result.findings.extend(project.errors)
    raw, seen = [], set()
    for name in sorted(checks):
        for f in checks[name](project):
            if f not in seen:
                seen.add(f)
                raw.append(f)
    for sf in project.files.values():
        for sups in sf.suppressions.values():
            result.suppressions.extend(sups)
    used = set()
    for f in raw:
        sf = project.files.get(f.path)
        match = None
        if sf is not None:
            for s in sf.suppressions.get(f.line, []):
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
            result.findings.append(finding_cls(
                "unused-suppression", s.path, s.line, s.reason))
    result.findings.sort(key=lambda f: (f.path, f.line, f.check))
    return result.to_dict()


def _both(root, config):
    from edl_tpu.analysis.checks import CHECKS as JCHECKS
    from edl_tpu.analysis.core import Finding as JFinding
    from edl_tpu.analysis.core import LintResult as JLintResult
    from edl_tpu.analysis.core import Project as JProject

    ours = _account(Project(root, config), CHECKS, Finding, LintResult)
    theirs = _account(JProject(root, config), JCHECKS, JFinding, JLintResult)
    return ours, theirs


def test_the_same_five_checks():
    from edl_tpu.analysis.checks import CHECKS as JCHECKS
    assert sorted(CHECKS) == sorted(JCHECKS) == [
        "env-registry", "guarded-by", "layering", "resource-lifecycle",
        "sim-determinism"]


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_synthetic_project_findings_match_jax(tmp_path, name):
    files, config, doc = PROJECTS[name]
    config = _make(tmp_path, files, config, doc)
    ours, theirs = _both(str(tmp_path), config)
    assert ours == theirs
    if name.endswith(("clean", "deferred", "method-local", "handoff",
                      "honored")):
        assert ours["ok"], ours["findings"]
    else:
        assert not ours["ok"]


def test_the_port_tree_under_the_jax_doc_table_matches_jax():
    """The port's own tree, linted against its map but with the JAX
    package's doc table: both packages' env, guarded-by, lifecycle and
    determinism checkers give the same (non-empty) findings."""
    with open(os.path.join(REPO_ROOT, "edl_tpu_torch", "analysis",
                           "layers.toml")) as f:
        config = load_toml_lite(f.read())
    config["env"]["doc"] = "doc/usage.md"
    from edl_tpu.analysis.checks import CHECKS as JCHECKS
    from edl_tpu.analysis.core import Project as JProject

    ours_p, theirs_p = Project(REPO_ROOT, config), JProject(REPO_ROOT, config)
    found_any = False
    for check in ("env-registry", "guarded-by", "resource-lifecycle",
                  "sim-determinism"):
        ours = sorted((f.check, f.path, f.line, f.message)
                      for f in CHECKS[check](ours_p))
        theirs = sorted((f.check, f.path, f.line, f.message)
                        for f in JCHECKS[check](theirs_p))
        assert ours == theirs, check
        found_any |= bool(ours)
    assert found_any


_TOML = [
    '# comment\n[layers.coord]\npackages = ["a", "b"]\n'
    'n = 3\nf = 1.5\nflag = true\nname = "x"\n',
    '[lint]\npaths = ["edl_tpu_torch"]\n[a.b.c]\nx = -2\ny = false\n'
    'z = []\nq = "with # hash"\n',
    "key = [unquoted",
    "just a line\n",
    '[t]\ns = "a\\"b"\n',
]


@pytest.mark.parametrize("text", _TOML, ids=range(len(_TOML)))
def test_toml_lite_matches_jax(text):
    from edl_tpu.analysis.core import load_toml_lite as jload

    def outcome(fn):
        try:
            return fn(text)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(load_toml_lite) == outcome(jload)


def test_the_port_layers_toml():
    path = os.path.join(REPO_ROOT, "edl_tpu_torch/analysis/layers.toml")
    with open(path) as f:
        cfg = load_toml_lite(f.read())
    assert cfg["lint"]["paths"] == ["edl_tpu_torch"]
    assert cfg["env"] == {"config_module": "edl_tpu_torch/utils/config.py",
                          "doc": "doc/usage_torch.md", "prefix": "EDL_TPU_"}
    assert cfg["determinism"]["files"] == [
        f"edl_tpu_torch/scaler/{m}.py"
        for m in ("simulator", "policy", "fleet", "fleet_policy")]
    with open(os.path.join(REPO_ROOT, "edl_tpu/analysis/layers.toml")) as f:
        ref = load_toml_lite(f.read())
    for name, spec in ref["layers"].items():
        ours = cfg["layers"][name]
        assert ours["packages"] == [p.replace("edl_tpu", "edl_tpu_torch", 1)
                                    for p in spec["packages"]]
        want = [m.replace("edl_tpu.", "edl_tpu_torch.")
                for m in spec["forbidden"]]
        if "jax" in spec["forbidden"]:
            want.append("torch")
        assert sorted(ours["forbidden"]) == sorted(want)
    assert set(cfg["layers"]["port"]["forbidden"]) >= {"jax", "edl_tpu"}


def test_the_port_lints_clean():
    result = run_lint(REPO_ROOT)
    assert result.ok, "\n".join(f.render() for f in result.findings)
    assert all(s.reason for s in result.suppressions)
    assert sorted(result.checks_run) == sorted(CHECKS)


def test_lint_cli_json_report(tmp_path):
    out_json = tmp_path / "lint.json"
    proc = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.analysis", "lint",
         "--root", REPO_ROOT, "--json", str(out_json)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "edl-lint: clean" in proc.stdout
    doc = json.loads(out_json.read_text())
    assert doc["ok"] is True
    assert set(doc["checks"]) == set(CHECKS)
    assert doc["findings"] == []


def test_lint_cli_fails_on_a_finding(tmp_path):
    (tmp_path / "edl_tpu_torch" / "analysis").mkdir(parents=True)
    (tmp_path / "edl_tpu_torch" / "__init__.py").write_text("")
    (tmp_path / "edl_tpu_torch" / "analysis" / "layers.toml").write_text(
        '[lint]\npaths = ["edl_tpu_torch"]\n[layers.port]\n'
        'packages = ["edl_tpu_torch"]\nforbidden = ["jax"]\n')
    (tmp_path / "edl_tpu_torch" / "bad.py").write_text("import jax\n")
    proc = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.analysis", "lint", "--root",
         str(tmp_path), "--check", "layering"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 1
    assert "edl_tpu_torch/bad.py:1: [layering]" in proc.stdout


def test_the_lint_half_imports_no_torch_numpy_or_jax():
    code = (
        "import sys\n"
        "import edl_tpu_torch.analysis\n"
        "import edl_tpu_torch.analysis.core\n"
        "import edl_tpu_torch.analysis.checks\n"
        "import edl_tpu_torch.analysis.__main__\n"
        "import edl_tpu_torch.analysis.lockgraph\n"
        "from edl_tpu_torch.analysis import run_lint\n"
        "run_lint('.', checks=['layering'])\n"
        "banned = [m for m in ('torch', 'numpy', 'jax')"
        " if m in sys.modules]\n"
        "assert not banned, f'analysis pulled in {banned}'\n"
        "print('PURE')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO_ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PURE" in out.stdout


def test_lockgraph_selftest_cli():
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.analysis",
         "lockgraph-selftest"], capture_output=True, text=True,
        cwd=REPO_ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
