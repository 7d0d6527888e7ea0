"""The port's serving engine against the JAX package's, on the CPU.

Reduced Zamba2, OLMoE, DeepSeek-V2-Lite and InternVL2 (fp32) with the same
weights, carried over by ``convert.model_params_from_reference``: the same
greedy tokens for ragged prompts; ``EngineConfig`` raises the same errors; ``comm_report`` prices
the same TP collectives.  The JAX engine runs its plain path
(``use_pallas=False``); the port runs both of its paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.serve import engine


@pytest.fixture(scope="module")
def zamba2():
    ref_cfg = ref_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(batch_size=3, max_len=40),
                                     seed=0)
    state = model_params_from_reference(cfg, jax.tree.map(np.asarray, ref_eng.params))
    return ref_cfg, cfg, ref_eng, state


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison.  In a fresh process
    with several OpenMP threads, the first batched MKL product on the CPU
    can come out wrong (observed with torch 2.13.0+cpu: errors near 1e-4 in
    the first ``ssd_reference`` call, none once a plain matmul has run)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _requests(module, lengths, new_tokens=5, seed=7):
    rng = np.random.default_rng(seed)
    return [module.Request(prompt=rng.integers(1, 256, size=n).astype(np.int32),
                           max_new_tokens=new_tokens - i)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generate_gives_the_reference_tokens(zamba2, use_pallas):
    ref_cfg, cfg, ref_eng, state = zamba2
    lengths = (11, 4, 8)  # ragged: the engine left-pads to the longest
    want = [r.generated for r in ref_eng.generate(_requests(ref_engine, lengths))]
    eng = engine.ServeEngine(dataclasses.replace(cfg, use_pallas=use_pallas),
                             engine.EngineConfig(batch_size=3, max_len=40), params=state,
                             device="cpu")
    served = eng.generate(_requests(engine, lengths))
    assert [r.generated for r in served] == want
    assert all(r.done for r in served) and [len(w) for w in want] == [5, 4, 3]
    assert eng.timings["decode_steps"] == 4 and eng.timings["prefill_s"] > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b", "internvl2-26b"])
def test_decoder_generate_gives_the_reference_tokens(arch):
    """The decoder family (MoE, MLA, VLM with its zero image embeddings),
    reduced, fp32, weights carried over: the same greedy tokens."""
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    ecfg = dict(batch_size=3, max_len=48)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), seed=1)
    state = model_params_from_reference(cfg, jax.tree.map(np.asarray, ref_eng.params))
    lengths = (11, 4, 8)
    want = [r.generated for r in ref_eng.generate(_requests(ref_engine, lengths))]
    eng = engine.ServeEngine(cfg, engine.EngineConfig(**ecfg), params=state, device="cpu")
    served = eng.generate(_requests(engine, lengths))
    assert [r.generated for r in served] == want and [len(w) for w in want] == [5, 4, 3]
    with pytest.raises(ValueError, match="max_len=48"):  # the image tokens take slots too
        eng.generate(_requests(engine, (48 - 8 * bool(cfg.vlm) - 4,), new_tokens=6))


def test_generate_refuses_more_tokens_than_kv_slots(zamba2):
    _, cfg, _, state = zamba2
    eng = engine.ServeEngine(cfg, engine.EngineConfig(batch_size=1, max_len=8), params=state,
                             device="cpu")
    with pytest.raises(ValueError, match="max_len=8"):
        eng.generate(_requests(engine, (6,), new_tokens=4))


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=0), dict(max_len=0), dict(batch_size=64, max_len=32), dict(tp=0),
    dict(dp=0), dict(tp=2, fabric=("FabricSection", dict(tp=2))),
    dict(greedy=False, model=("ModelSection", {})),
    dict(max_len=64, runtime=("RuntimeSection", {})),
])
def test_engine_config_raises_the_reference_errors(kwargs):
    def build(module):
        kw = {k: getattr(module, v[0])(**v[1]) if isinstance(v, tuple) else v
              for k, v in kwargs.items()}
        with pytest.raises(ValueError) as err:
            module.EngineConfig(**kw)
        return str(err.value)

    assert build(engine) == build(ref_engine)


def test_fabric_section_raises_the_reference_error():
    msgs = []
    for module in (ref_engine, engine):
        with pytest.raises(ValueError) as err:
            module.FabricSection(tp=4, dp=2, mesh_n=16)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "mesh_n=16" in msgs[0]


def test_engine_config_sections_equal_reference():
    flat = engine.EngineConfig(batch_size=2, max_len=32, greedy=False, tp=2, dp=2)
    ref = ref_engine.EngineConfig(batch_size=2, max_len=32, greedy=False, tp=2, dp=2)
    assert (flat.batch_size, flat.max_len, flat.greedy, flat.tp, flat.dp) == (
        ref.batch_size, ref.max_len, ref.greedy, ref.tp, ref.dp)
    assert flat == engine.EngineConfig(model=engine.ModelSection(greedy=False),
                                       runtime=engine.RuntimeSection(2, 32),
                                       fabric=engine.FabricSection(tp=2, dp=2))
    assert dataclasses.asdict(flat.fabric) == dataclasses.asdict(ref.fabric)
    assert flat.fabric.n == ref.fabric.n == 4


def test_comm_report_at_tp4_equals_reference(zamba2):
    ref_cfg, cfg, ref_eng, state = zamba2
    ecfg = dict(batch_size=2, max_len=32, tp=4)
    ref = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), params=ref_eng.params)
    eng = engine.ServeEngine(cfg, engine.EngineConfig(**ecfg), params=state, device="cpu")
    for e, m in ((ref, ref_engine), (eng, engine)):
        e.generate(_requests(m, (6, 3), new_tokens=4))
    want, got = ref.comm_report(), eng.comm_report()
    for key in ("tp", "sim_comm_s", "algorithm", "events"):
        assert got[key] == want[key], key
    assert got["events"] == 2 * cfg.n_layers * 4 and got["sim_comm_s"] > 0
    assert engine.ServeEngine(cfg, engine.EngineConfig(batch_size=2, max_len=32), params=state,
                              device="cpu").comm_report() == {
        "tp": 1, "sim_comm_s": 0.0, "algorithm": "none", "events": 0}
    assert eng.concurrent_report() == {"tp": 4, "dp": 1, "speedup": 1.0, "serialized": False}
    for e in (ref, eng):  # the arbiter spans TP rows and DP columns: dp = 1 has none
        with pytest.raises(ValueError, match="dp >= 2"):
            e.arbiter()


def test_engine_defaults_to_cuda():
    cfg = get_config("zamba2-2.7b").reduced()
    if torch.cuda.is_available():
        eng = engine.ServeEngine(cfg, engine.EngineConfig(batch_size=1, max_len=8))
        assert eng.device.type == "cuda"
        assert all(p.device.type == "cuda" for p in eng.params.parameters())
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.ServeEngine(cfg, engine.EngineConfig(batch_size=1, max_len=8))
