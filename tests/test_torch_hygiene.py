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
EXAMPLE = ROOT / "examples" / "pccl_dp_training_torch.py"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.comm.fusion" in mods and "repro_torch.models.moe" in mods
    assert {"repro_torch.train.optimizer", "repro_torch.train.data_parallel",
            "repro_torch.data.pipeline", "repro_torch.kernels.autograd",
            "repro_torch.sharding", "repro_torch.sharding.partition",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.perf", "repro_torch.launch.procs",
            "repro_torch.runtime.fault"} <= set(mods)
    assert len(mods) > 20
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('example', {str(EXAMPLE)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def test_a_spawned_rank_loads_no_jax_and_no_repro(tmp_path):
    """A rank that ``repro_torch.launch.procs.spawn`` starts imports the
    package afresh (the ``spawn`` method), never the caller's modules: the
    card's machine has no JAX."""
    from repro_torch.launch import procs

    for mods in procs.spawn(procs.loaded_modules, 2, store_dir=str(tmp_path), timeout_s=120):
        assert "repro_torch.launch.procs" in mods
        bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
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


@pytest.mark.parametrize("name", ["matmul", "flash", "ssd"])
def test_kernel_sources_are_in_the_package(name):
    import importlib

    from repro_torch.kernels.build import NVCC_FLAGS, library_path

    source = importlib.import_module(f"repro_torch.kernels.{name}.kernel").SOURCE
    assert source.exists() and source.suffix == ".cu"
    assert source.parent == PKG / "kernels" / name / "csrc"
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    lib = library_path(source)
    assert lib.parent.name == "_build" and lib.name.startswith(f"{name}-")
    # every source names the TPU kernel it replaces
    assert f"src/repro/kernels/{name}/kernel.py::" in source.read_text()
    # the build directory is ignored by git
    assert "src/repro_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_meshes_default_to_cuda_and_raise_without_it():
    """``make_mesh`` builds a CUDA mesh unless asked for another device type;
    the dry run asks for CPU ranks of a fake group (in a subprocess: a
    process group is global to the process)."""
    code = (
        "import torch\n"
        "from repro_torch.launch.mesh import init_fake_world, make_mesh\n"
        "init_fake_world(4)\n"
        "if torch.cuda.is_available():\n"
        "    print('TYPE', make_mesh((2, 2), ('data', 'model')).device_type)\n"
        "else:\n"
        "    try:\n"
        "        make_mesh((2, 2), ('data', 'model'))\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', 'CUDA' in str(e))\n"
        "try:\n"
        "    make_mesh((4, 2), ('data', 'model'), device_type='cpu')\n"
        "except RuntimeError as e:\n"
        "    print('SMALL', 'dryrun' in str(e))\n"
        "print('CPU', make_mesh((2, 2), ('data', 'model'), device_type='cpu').device_type)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = "TYPE cuda" if torch.cuda.is_available() else "RAISED True"
    assert want in proc.stdout and "SMALL True" in proc.stdout and "CPU cpu" in proc.stdout
