"""The port stands alone: it imports neither JAX nor the JAX package.

The import check runs in a subprocess: a test worker may already hold JAX
(other test files import it), so only a fresh interpreter shows what the
port itself pulls in.  An AST scan of the sources backs it up.  The entry
points run on CUDA unless asked for the CPU, and raise without CUDA.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.comm.fusion" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_sources_import_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_session_defaults_to_cuda_and_raises_without_it():
    from repro_torch import PcclSession
    from repro_torch.core import cost_model as cm

    if torch.cuda.is_available():
        assert PcclSession(cm.H100_DGX).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PcclSession(cm.H100_DGX)
    with pytest.raises(RuntimeError, match="CUDA"):
        PcclSession(cm.H100_DGX, device="cuda")
    session = PcclSession(cm.H100_DGX, device="cpu")
    comm = session.communicator("x", 4)
    assert comm.device == torch.device("cpu")
    assert comm.split([0, 1, 0, 1]).device == comm.device


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels.build import NVCC_FLAGS, library_path
    from repro_torch.kernels.matmul.kernel import SOURCE

    assert SOURCE.exists() and SOURCE.suffix == ".cu"
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    lib = library_path(SOURCE)
    assert lib.parent.name == "_build" and lib.name.startswith("matmul-")
    # the build directory is ignored by git
    assert "src/repro_torch/_build/" in (ROOT / ".gitignore").read_text()
