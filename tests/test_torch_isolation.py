"""The port stands alone: no file of `pixart_sigma_tpu_torch` nor
`chip_smoke.py` imports JAX, flax or the JAX package, and the package
imports with those blocked."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pixart_sigma_tpu"}
PORT_FILES = sorted((ROOT / "pixart_sigma_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    assert len(PORT_FILES) > 10
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"pixart_sigma_tpu_torch/models/t5.py", "pixart_sigma_tpu_torch/data/transforms.py",
            "pixart_sigma_tpu_torch/tools/extract_features.py",
            "pixart_sigma_tpu_torch/ops/quant.py", "pixart_sigma_tpu_torch/scripts/serve.py",
            "pixart_sigma_tpu_torch/scripts/inference.py",
            "pixart_sigma_tpu_torch/parallel/__init__.py",
            "pixart_sigma_tpu_torch/parallel/dist.py", "pixart_sigma_tpu_torch/parallel/mesh.py",
            "pixart_sigma_tpu_torch/parallel/sharded.py"} <= names
    for path in PORT_FILES:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = (
        "import sys, importlib\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_parallel_worker_imports_no_jax():
    """The multi-rank tests' worker processes import torch and the port
    only (the JAX references are computed in the test process)."""
    path = ROOT / "tests" / "torch_parallel_worker.py"
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, sorted(bad)
