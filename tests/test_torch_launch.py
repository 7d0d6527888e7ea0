"""The port's command-line entry points, examples and ``PcclComm`` shim
against the JAX package's, on the CPU.

* ``python -m repro_torch.launch.serve`` and ``examples/serve_decode_torch.py``
  on reduced Zamba2 with the reference engine's weights carried over
  (``convert.model_params_from_reference``): the same greedy tokens and
  the same printed result lines as ``repro.launch.serve`` and
  ``examples/serve_decode.py``.  ``--no-reduced`` serves the published config.
* ``examples/quickstart_torch.py`` at the reference's n = 128: the same
  plan lines.
* ``python -m repro_torch.analysis --quick`` in a fresh process: the same
  section lines as the reference's, timings aside; ``--kernels`` exits
  non-zero citing ROADMAP item 15.
* ``python -m repro_torch.analysis.lint_concurrency``: 0 findings.
* ``PcclComm``: its warning, its cold session, its plans equal to the
  reference's shim, its collectives bit-identical to the communicator's.

Everything is exact but the wall-clock figures the CLIs print.
"""

import importlib.util
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
MB = 1024.0 ** 2


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(cmd, **env):
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env))
    return proc.returncode, proc.stdout, proc.stderr


def _untimed(text):
    """Printed lines with the wall-clock figures taken out."""
    text = re.sub(r"\(\d+\.\d+s\)", "(t)", text)
    text = re.sub(r"in \d+\.\d+s \(\d+\.\d+ tok/s", "in t (r tok/s", text)
    return text.splitlines()


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison.  In a fresh process
    with several OpenMP threads, the first batched MKL product on the CPU
    can come out wrong (observed with torch 2.13.0+cpu: errors near 1e-4 in
    the first ``ssd_reference`` call, none once a plain matmul has run)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _serve_both(monkeypatch, capsys, ref_module, port_module, ref_argv, port_argv):
    """Run the reference entry point (its own engine and weights), then the
    port's with those weights carried over; return both printed outputs
    and both engines' served requests."""
    seen = {}

    class RefEngine(ref_module.ServeEngine):
        def generate(self, requests):
            seen["ref_engine"] = self
            seen["ref_out"] = super().generate(requests)
            return seen["ref_out"]

    monkeypatch.setattr(ref_module, "ServeEngine", RefEngine)
    monkeypatch.setattr(sys, "argv", ref_argv)
    capsys.readouterr()
    ref_module.main()
    ref_printed = capsys.readouterr().out

    Engine = port_module.ServeEngine

    class CarriedEngine(Engine):
        def __init__(self, cfg, ecfg, **kw):
            params = jax.tree.map(np.asarray, seen["ref_engine"].params)
            super().__init__(cfg, ecfg, params=model_params_from_reference(cfg, params), **kw)

    monkeypatch.setattr(port_module, "ServeEngine", CarriedEngine)
    out = port_module.main(port_argv)
    return ref_printed, capsys.readouterr().out, seen["ref_out"], out


def test_serve_cli_gives_the_reference_tokens(monkeypatch, capsys):
    ref_printed, printed, ref_out, out = _serve_both(
        monkeypatch, capsys, ref_serve, serve,
        ["serve", "--arch", "zamba2-2.7b"], ["--arch", "zamba2-2.7b", "--device", "cpu"])
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert len(out) == 4 and all(len(r.generated) == 16 for r in out)
    lines = _untimed(printed)
    assert lines[0] == "[serve] zamba2-2.7b (reduced config, d_model 64, 4 layers) on cpu"
    assert lines[1:] == _untimed(ref_printed)  # the reference's two lines, the same


def test_serve_decode_example_gives_the_reference_tokens(monkeypatch, capsys):
    ref_example, example = _example("serve_decode"), _example("serve_decode_torch")
    ref_printed, printed, ref_out, out = _serve_both(
        monkeypatch, capsys, ref_example, example, ["serve_decode"], ["--device", "cpu"])
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    assert _untimed(printed) == _untimed(ref_printed)


@pytest.mark.parametrize("argv,reduced", [([], True), (["--reduced"], True),
                                          (["--no-reduced"], False)])
def test_serve_cli_reduced_flag(monkeypatch, argv, reduced):
    """The reference's ``--reduced`` is always on; the port's is the default
    and ``--no-reduced`` serves the published config."""
    made = []

    class Stop(Exception):
        pass

    def engine(cfg, ecfg, **kw):
        made.append((cfg, ecfg, kw))
        raise Stop

    monkeypatch.setattr(serve, "ServeEngine", engine)
    with pytest.raises(Stop):
        serve.main(["--arch", "zamba2-2.7b", *argv])
    cfg, ecfg, kw = made[0]
    published = get_config("zamba2-2.7b")
    assert cfg == (published.reduced() if reduced else published)
    assert (ecfg.batch_size, ecfg.max_len, kw) == (4, 32, {"device": None})


def test_serve_cli_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is here: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "zamba2-2.7b"])


def test_quickstart_prints_the_reference_plans(capsys):
    ref, port = _example("quickstart"), _example("quickstart_torch")
    ref.main()
    want = capsys.readouterr().out.splitlines()
    port.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) and got[:-1] == want[:-1]
    algo = re.search(r"runs '(\w+)'", want[-1]).group(1)
    assert f"on cpu runs '{algo}' rounds" in got[-1]
    assert "PCCL (rhd schedule, 7 reconfigs)" in "\n".join(got)


def test_analysis_cli_prints_the_reference_sections():
    rc, out, err = _run(["-m", "repro_torch.analysis", "--quick"])
    ref_rc, ref_out, _ = _run(["-m", "repro.analysis", "--quick"])
    assert rc == ref_rc == 0, err
    assert _untimed(out) == _untimed(ref_out)
    assert out.splitlines()[0].startswith("[verify] dataflow (78 schedules): ok")
    assert out.splitlines()[-1] == "[verify] PASS"


def test_analysis_cli_kernels_is_not_ported():
    rc, out, err = _run(["-m", "repro_torch.analysis", "--kernels"])
    assert rc == 2 and "PASS" not in out
    assert "ROADMAP item 15" in err
    import repro_torch.analysis as analysis

    for name in ("KernelReport", "verify_entry_point", "whole_array_box", "capture_call_sites"):
        with pytest.raises(AttributeError, match="ROADMAP item 15"):
            getattr(analysis, name)
    assert analysis.lint_module.__module__ == "repro_torch.analysis.lint_concurrency"


def test_lint_cli_finds_nothing_in_the_port():
    rc, out, err = _run(["-m", "repro_torch.analysis.lint_concurrency"])
    assert rc == 0, out + err
    assert out.splitlines() == ["concurrency lint: 0 finding(s) in src/repro_torch"]


# ---------------------------------------------------------------- PcclComm


def _pcclcomm(**kw):
    from repro_torch.comm.pccl_collectives import PcclComm

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        comm = PcclComm(**kw)
    return comm, caught


def test_pcclcomm_warns_and_plans_cold():
    from repro_torch.core.pccl import SHIM_REMOVAL_VERSION

    comm, caught = _pcclcomm(axis_name="x", n=8, device="cpu")
    assert [w.category for w in caught] == [DeprecationWarning]
    message = str(caught[0].message)
    assert SHIM_REMOVAL_VERSION in message and "PcclSession.communicator()" in message
    assert comm._session.thread_fabric is False
    assert comm._comm.backend.name == "interp" and comm._comm.device == torch.device("cpu")
    a1 = comm._schedule("all_reduce", 4 * MB)
    assert comm._schedule("all_reduce", 4 * MB) is a1  # the session's plan cache
    xla, _ = _pcclcomm(axis_name="x", n=8, algorithm="xla", device="cpu")
    assert xla._comm.backend.name == "native" and xla._comm.algorithm == "auto"


def test_pcclcomm_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        comm, _ = _pcclcomm(axis_name="x", n=8)
        assert comm._comm.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        _pcclcomm(axis_name="x", n=8)


@pytest.mark.parametrize("hw_name", ["TPU_V5E_PHOTONIC", "H100_DGX"])
@pytest.mark.parametrize("algorithm", ["auto", "ring", "rhd"])
def test_pcclcomm_plans_as_the_reference(hw_name, algorithm):
    from repro.comm.pccl_collectives import PcclComm as RefComm
    from repro.core import cost_model as ref_cm
    from repro_torch.core import cost_model as cm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = RefComm(axis_name="x", n=8, hw=getattr(ref_cm, hw_name), algorithm=algorithm)
    comm, _ = _pcclcomm(axis_name="x", n=8, hw=getattr(cm, hw_name), algorithm=algorithm,
                        device="cpu")
    colls = ("all_reduce", "reduce_scatter", "all_gather") + (
        () if algorithm == "rhd" else ("all_to_all",))  # no RHD all-to-all
    for coll in colls:
        for nbytes in (64 * 4, 4 * MB, 256 * MB):
            assert comm.chosen_algorithm(coll, nbytes) == ref.chosen_algorithm(coll, nbytes)
            assert (comm._schedule(coll, nbytes).fingerprint()
                    == ref._schedule(coll, nbytes).fingerprint())
    assert comm.g0.edges == ref.g0.edges


@pytest.mark.parametrize("algorithm", ["auto", "xla", "ring"])
def test_pcclcomm_collectives_bit_identical_to_the_communicator(algorithm):
    from repro_torch.api import PcclSession
    from repro_torch.core import cost_model as cm

    n = 8
    comm, _ = _pcclcomm(axis_name="x", n=n, hw=cm.H100_DGX, algorithm=algorithm, device="cpu")
    direct = PcclSession(cm.H100_DGX, thread_fabric=False, device="cpu").communicator(
        "x", n, backend="native" if algorithm == "xla" else "interp",
        algorithm="auto" if algorithm == "xla" else algorithm)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, 6 * n, 3)).astype(np.float32))
    shard = torch.from_numpy(rng.normal(size=(n, 5, 3)).astype(np.float32))
    for coll, operand in (("all_reduce", x), ("reduce_scatter", x), ("all_gather", shard),
                          ("all_to_all", x)):
        assert torch.equal(getattr(comm, coll)(operand), getattr(direct, coll)(operand)), coll
