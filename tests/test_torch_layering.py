"""The port stands alone: no file of edl_tpu_torch/ and not chip_smoke.py
imports jax, flax, optax, msgpack, ml_dtypes or anything of edl_tpu (an
AST check, so function-scoped imports count too): the checkpoint payload
is written without the msgpack package and read without ml_dtypes, which
the card's machine lacks. cv2 is imported only inside a function of
data/image.py, the JPEG plane, so every other plane runs without it. The
elastic launcher's modules, the reform machine and the coordination store
(the utilization publisher too) import no torch (nor numpy), so a
launcher starts fast and holds no CUDA context: by the same AST check,
and by importing their entry points, and the migration plane the
launcher waits on, in a fresh interpreter."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "edl_tpu", "msgpack",
             "ml_dtypes")
FILES = sorted((ROOT / "edl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_edl_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for mod, line in _imported(tree) if _forbidden(mod)]
    assert not bad, bad


def test_checker_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom edl_tpu.ops import pack\n"
           "import importlib\nimportlib.import_module('flax.linen')\n"
           "from edl_tpu_torch import bridge\nimport torch\n")
    found = [m for m, _ in _imported(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "edl_tpu.ops", "flax.linen"]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_cv2_only_lazily_in_the_jpeg_plane(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    uses = [line for mod, line in _imported(tree)
            if mod.split(".")[0] == "cv2"]
    if path != ROOT / "edl_tpu_torch" / "data" / "image.py":
        assert not uses, f"{path.name} imports cv2 at {uses}"
        return
    top = {n.lineno for n in tree.body
           if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert uses and not top & set(uses)


PKG = ROOT / "edl_tpu_torch"
LAUNCHER_SIDE = sorted(
    [PKG / "collective" / f"{m}.py" for m in (
        "launch", "register", "barrier", "watcher", "process", "cluster",
        "job_env", "reform")] + list((PKG / "coord").glob("*.py"))
    + [PKG / "utils" / f"{m}.py" for m in (
        "backoff", "unique_name", "net", "config", "exceptions",
        "logging")]
    + [PKG / "obs" / f"{m}.py" for m in ("recorder", "trace", "metrics")])


def test_the_glob_collects_the_launcher_side():
    assert set(LAUNCHER_SIDE) <= set(FILES)
    assert PKG / "coord" / "server.py" in LAUNCHER_SIDE


@pytest.mark.parametrize("path", LAUNCHER_SIDE,
                         ids=[str(p.relative_to(ROOT)) for p in LAUNCHER_SIDE])
def test_the_launcher_side_imports_no_torch(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for mod, line in _imported(tree)
           if mod.split(".")[0] in ("torch", "numpy", "triton")]
    assert not bad, bad


def test_launcher_and_store_server_start_without_torch():
    """The launcher reaches the migration plane (wait_adopted), whose
    tensor wire and checkpoint chunks are imported only where a snapshot
    is served or fetched."""
    code = ("import sys; import edl_tpu_torch.collective.launch, "
            "edl_tpu_torch.collective.migration, "
            "edl_tpu_torch.coord.server, edl_tpu_torch.coord.collector; "
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


DISCOVERY_PLANE = [PKG / m for m in (
    "coord/consistent_hash.py", "coord/registry.py", "distill/__init__.py",
    "distill/balance.py", "distill/discovery_client.py",
    "distill/discovery_server.py", "distill/registrar.py")]


@pytest.mark.parametrize("path", DISCOVERY_PLANE, ids=[
    str(p.relative_to(ROOT)) for p in DISCOVERY_PLANE])
def test_the_discovery_plane_imports_no_torch(path):
    """The balancer daemon, its client, the hash ring, the registry and
    the registrar import neither torch nor numpy at any scope but the
    registrar's stats poll (the teacher client, numpy only)."""
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}"
           for mod, line in _imported(tree)
           if mod.split(".")[0] in ("torch", "numpy", "triton")]
    assert not bad, bad


def test_the_discovery_daemon_and_registrar_start_without_torch():
    code = ("import sys; import edl_tpu_torch.distill.discovery_server, "
            "edl_tpu_torch.distill.discovery_client, "
            "edl_tpu_torch.distill.registrar, edl_tpu_torch.distill; "
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


DISTILL_SLICE = ["models/mlp.py", "models/bow.py", "distill/reader.py",
                 "distill/tensor_wire.py", "distill/sharded_teacher.py",
                 "distill/teacher_server.py", "examples/mnist_distill.py",
                 "examples/nlp_distill.py", "examples/reader_demo.py"]


@pytest.mark.parametrize("module", DISTILL_SLICE)
def test_the_distill_slice_is_checked(module):
    assert PKG / module in FILES


WORLD_SLICE = ["parallel/mesh.py", "parallel/sharding.py",
               "parallel/distributed.py", "train/step.py", "train/dgc.py",
               "train/comm.py", "train/sharded_checkpoint.py",
               "train/checkpoint.py", "models/resnet.py",
               "models/transformer.py", "models/linear.py", "bridge.py",
               "examples/lm_train.py", "examples/imagenet_train.py",
               "examples/multipod_demo.py"]


@pytest.mark.parametrize("module", WORLD_SLICE)
def test_the_world_slice_is_checked_and_clean(module):
    """The world step's modules are in the checked set, import no
    forbidden package, and import torch.distributed's meshes nowhere:
    their collectives go through the port's staged ones."""
    path = PKG / module
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = [m for m, _ in _imported(tree)]
    assert not [m for m in mods if _forbidden(m)]
    assert not [m for m in mods if m.startswith(
        ("torch.distributed.device_mesh", "torch.distributed.tensor",
         "torch.distributed.fsdp", "torch.distributed._composable"))]
    text = path.read_text()
    assert "SyncBatchNorm(" not in text
    assert "convert_sync_batchnorm" not in text
