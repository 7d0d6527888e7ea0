"""The port's xLSTM family against the JAX package, on the CPU.

``apply_mlstm`` and ``apply_slstm`` in train, prefill (from a non-zero
state) and decode modes; the reduced ``XLSTMLM`` (prefill and two decode
steps, greedy serving) with the reference's weights carried over by
``convert.model_params_from_reference``; its full-size parameter shapes;
and K4's plain version at the mLSTM's proportions (P = 2N, per-head B/C,
an initial state).  The same numpy inputs go to both sides.

The JAX side runs its plain path (``use_pallas=False``): with the Pallas
SSD kernel its ``XLSTMLM.prefill`` asserts (the kernel takes no initial
state, and the prefill hands it the zero state), and its ``ServeEngine``
passes ``max_len`` to a prefill that takes none, so the JAX engine here
runs its own ``generate`` loop around the model's prefill without it.
Tolerances: fp32 2e-5 for a module and 1e-4 for a model (sums in another
order, through four layers); bf16 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.kernels.ssd import ref as ref_ssd
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro.models.module import unbox
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels.ssd import ssd
from repro_torch.models import ParamTree, XLSTMLM, build_model, param_count, ssm
from repro_torch.serve import engine

TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
TOL16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison (see
    tests/test_torch_models.py: the first batched MKL product of a fresh
    process can come out wrong)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _f32(a):
    """A JAX array or a torch tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _cfgs(**kw):
    return (dataclasses.replace(ref_configs.get_config("xlstm-1.3b").reduced(), **kw),
            dataclasses.replace(configs.get_config("xlstm-1.3b").reduced(), **kw))


def _check(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=what)


def _run_module(apply, ref_apply, p, ref_cfg, cfg, x, st, ref_st, mode, dtype):
    """The reference once, the port with ``use_pallas`` off and on (both
    plain on the CPU); outputs and new states within the dtype's tolerance."""
    jdt, tdt = DTYPES[dtype]
    tol = TOL32 if dtype == "float32" else TOL16
    want, want_st = ref_apply({k: jnp.asarray(v) for k, v in p.items()}, ref_cfg,
                              jnp.asarray(x).astype(jdt), state=ref_st, mode=mode)
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        got, got_st = apply(_torch_tree(p), c, torch.from_numpy(x).to(tdt), state=st, mode=mode)
        assert got.dtype == tdt and got.shape == x.shape
        _check(got, want, tol, f"{mode} output")
        if mode == "train":
            assert got_st is None and want_st is None
            continue
        assert type(got_st).__name__ == type(want_st).__name__
        for name, a, b in zip(got_st._fields, got_st, want_st):
            assert a.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[b.dtype.type], name
            _check(a, b, tol, f"{mode} state {name}")


# -------------------------------------------------------------------- mLSTM
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_mlstm_matches_reference(mode, dtype):
    """Prefill and decode start from a non-zero fp32 state, as a decode
    after a prefill does; train from none."""
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(11)
    p = _np_tree(unbox(ref_ssm.init_mlstm(jax.random.PRNGKey(2), ref_cfg)))
    H = cfg.n_heads
    p["b_fgate"] = (p["b_fgate"] + rng.normal(size=H) * 2).astype(np.float32)
    p["b_igate"] = (rng.normal(size=H)).astype(np.float32)
    di, _, P, N = ssm._mlstm_dims(cfg)
    B, S = 2, 1 if mode == "decode" else 37  # ragged against chunk 16
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    C0 = (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32)
    n0 = np.abs(rng.normal(size=(B, H, 1, N))).astype(np.float32)
    st = ref_st = None
    if mode != "train":
        st = ssm.MLSTMState(torch.from_numpy(C0), torch.from_numpy(n0))
        ref_st = ref_ssm.MLSTMState(jnp.asarray(C0), jnp.asarray(n0))
    _run_module(ssm.apply_mlstm, ref_ssm.apply_mlstm, p, ref_cfg, cfg, x, st, ref_st, mode, dtype)


# -------------------------------------------------------------------- sLSTM
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_slstm_matches_reference(mode, dtype):
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(12)
    p = _np_tree(unbox(ref_ssm.init_slstm(jax.random.PRNGKey(3), ref_cfg)))
    assert np.all(p["b"][1] == 2.0) and np.all(p["b"][[0, 2, 3]] == 0.0)  # forget-gate bias
    H, Dh = ssm._slstm_dims(cfg)
    B, S = 2, 1 if mode == "decode" else 23
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    st = ref_st = None
    if mode != "train":
        h, c = (rng.normal(size=(B, H, Dh)).astype(np.float32) for _ in range(2))
        n = (np.abs(rng.normal(size=(B, H, Dh))) + 0.5).astype(np.float32)
        m = rng.normal(size=(B, H, Dh)).astype(np.float32)
        st = ssm.SLSTMState(*(torch.from_numpy(a) for a in (h, c, n, m)))
        ref_st = ref_ssm.SLSTMState(*(jnp.asarray(a) for a in (h, c, n, m)))
    _run_module(ssm.apply_slstm, ref_ssm.apply_slstm, p, ref_cfg, cfg, x, st, ref_st, mode, dtype)


def test_mlstm_hands_the_kernel_contiguous_operands(monkeypatch):
    """K4 on the card takes contiguous operands only; the mLSTM's per-head
    einsums hand back permuted strides, so the prefill makes them
    contiguous before the scan (the plain version takes either)."""
    _, cfg = _cfgs(use_pallas=True)
    seen = []

    def scan(*args, **kwargs):
        seen.append([a.is_contiguous() for a in args] + [kwargs["initial_state"].is_contiguous()])
        return ssd(*args, **kwargs)

    monkeypatch.setattr(ssm.ssd_ops, "ssd", scan)
    model = build_model(cfg)
    tree = model.init(torch.Generator().manual_seed(0), "cpu")
    with torch.inference_mode():
        model.prefill(tree, {"tokens": torch.randint(0, cfg.vocab, (2, 20))})
    assert seen == [[True] * 5] * (model.n_groups * model.m_per_group)


def test_init_states_match_reference():
    ref_cfg, cfg = _cfgs()
    for mine, ref in ((ssm.init_mlstm_state(cfg, 3, torch.float32),
                       ref_ssm.init_mlstm_state(ref_cfg, 3, jnp.float32)),
                      (ssm.init_slstm_state(cfg, 3, torch.float32),
                       ref_ssm.init_slstm_state(ref_cfg, 3, jnp.float32))):
        assert mine._fields == ref._fields
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # m starts at -30


# ---------------------------------------------------------------------- K4
@pytest.mark.parametrize("S", [128, 100])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_plain_version_at_mlstm_proportions(S, dtype):
    """The mLSTM's scan: P = 2N (1024 and 512 at full size), per-head B/C
    (k and q), an fp32 initial state, chunk 64; S ragged or whole."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    B, H, P, N = 2, 4, 64, 32
    X = rng.normal(size=(B, S, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(B, S, H))) * 0.1).astype(np.float32)
    Bm, Cm = ((rng.normal(size=(B, S, H, N)) * 0.3).astype(np.float32) for _ in range(2))
    init = (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32)
    want = ref_ssd.ssd_reference(*(jnp.asarray(a).astype(jdt) for a in (X,)),
                                 jnp.asarray(la), jnp.asarray(Bm).astype(jdt),
                                 jnp.asarray(Cm).astype(jdt), chunk=64,
                                 initial_state=jnp.asarray(init))
    got = ssd(torch.from_numpy(X).to(tdt), torch.from_numpy(la), torch.from_numpy(Bm).to(tdt),
              torch.from_numpy(Cm).to(tdt), chunk=64, initial_state=torch.from_numpy(init))
    tol = TOL32 if dtype == "float32" else TOL16
    for a, b, what in zip(got, want, ("Y", "final state")):
        assert a.dtype == tdt, what  # the final state in X's dtype, as the reference
        _check(a, b, tol, what)


# -------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def xlstm():
    """Reduced xLSTM in fp32: the reference model and weights, carried over."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build_model(ref_cfg)
    params = unbox(ref_model.init(jax.random.PRNGKey(0)))
    return ref_cfg, cfg, ref_model, params, model_params_from_reference(cfg, _np_tree(params))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_xlstm_prefill_and_decode_match_reference(xlstm, use_pallas):
    ref_cfg, cfg, ref_model, params, state = xlstm
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    assert isinstance(model, XLSTMLM) and (model.n_groups, model.m_per_group) == (2, 1)
    tree = ParamTree.from_state_dict(state)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 41)).astype(np.int32)
    want, ref_st = jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(toks[:, :39])})
    with torch.inference_mode():
        got, st = model.prefill(tree, {"tokens": torch.from_numpy(toks[:, :39]).long()},
                                max_len=64)
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_MODEL)
        step = jax.jit(ref_model.decode_step)
        for i in (39, 40):
            want, ref_st = step(params, ref_st, jnp.asarray(toks[:, i:i + 1]))
            got, st = model.decode_step(tree, st, torch.from_numpy(toks[:, i:i + 1]).long())
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_MODEL)
    for kind in ("mlstm", "slstm"):
        for name, a, b in zip(st[kind]._fields, st[kind], ref_st[kind]):
            assert tuple(a.shape) == b.shape, (kind, name)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_MODEL, err_msg=f"{kind}.{name}")


def test_xlstm_decode_state_is_fp32_and_stacked(xlstm):
    _, cfg, ref_model, _, _ = xlstm
    mine = build_model(cfg).init_decode_state(3, 0, "cpu")
    ref = ref_model.init_decode_state(3)
    for kind in ("mlstm", "slstm"):
        for a, b in zip(mine[kind], ref[kind]):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_xlstm_generate_gives_the_reference_tokens(xlstm):
    """Greedy serving of ragged prompts: the JAX engine's own ``generate``
    loop, its jitted prefill taken without ``max_len``, against the port's
    engine; the same tokens."""
    ref_cfg, cfg, _, params, state = xlstm
    ecfg = dict(batch_size=3, max_len=40)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), params=params)
    ref_eng._prefill = jax.jit(ref_eng.model.prefill)
    lengths = (11, 4, 8)

    def requests(module):
        rng = np.random.default_rng(7)
        return [module.Request(prompt=rng.integers(1, 256, size=n).astype(np.int32),
                               max_new_tokens=5 - i) for i, n in enumerate(lengths)]

    want = [r.generated for r in ref_eng.generate(requests(ref_engine))]
    for use_pallas in (False, True):
        eng = engine.ServeEngine(dataclasses.replace(cfg, use_pallas=use_pallas),
                                 engine.EngineConfig(**ecfg), params=state, device="cpu")
        served = eng.generate(requests(engine))
        assert [r.generated for r in served] == want and [len(w) for w in want] == [5, 4, 3]
        assert eng.timings["decode_steps"] == 4


def test_xlstm_tp_pricing_equals_reference(xlstm):
    """``comm_report`` at tp = 4 after serving: 2 · n_layers all-reduces a
    step, priced as the reference prices them."""
    ref_cfg, cfg, _, params, state = xlstm
    ecfg = dict(batch_size=2, max_len=32, tp=4)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), params=params)
    ref_eng._prefill = jax.jit(ref_eng.model.prefill)
    eng = engine.ServeEngine(cfg, engine.EngineConfig(**ecfg), params=state, device="cpu")
    prompts = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
    ref_eng.generate([ref_engine.Request(prompt=p, max_new_tokens=3) for p in prompts])
    eng.generate([engine.Request(prompt=p, max_new_tokens=3) for p in prompts])
    got, want = eng.comm_report(), ref_eng.comm_report()
    assert got["events"] == want["events"] == 2 * cfg.n_layers * 3
    assert got["algorithm"] == want["algorithm"]
    np.testing.assert_allclose(got["sim_comm_s"], want["sim_comm_s"], rtol=1e-12)


# -------------------------------------------------------------- parameters
def test_model_params_from_reference_is_exact_and_strict_on_nested_stacks(xlstm):
    """``groups.mlstm`` carries two stacked axes, (G, Mg, …)."""
    ref_cfg, cfg, _, params, state = xlstm
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(state)
    G, Mg = 2, 1
    assert state["groups.mlstm.p.wq"].shape == (G, Mg, *flat["groups.mlstm.p.wq"].shape[2:])
    assert state["groups.slstm.p.r"].shape[0] == G
    for name, t in state.items():
        assert np.array_equal(t.numpy(), flat[name]), name
    tree = ParamTree.from_state_dict(state)
    assert set(tree.state_dict()) == set(state)
    tree_np = _np_tree(params)
    groups = tree_np["groups"]
    flat_mlstm = dict(groups, mlstm=dict(groups["mlstm"], p=dict(
        groups["mlstm"]["p"], up=groups["mlstm"]["p"]["up"][:, 0])))  # one stacked axis lost
    with pytest.raises(ValueError, match=r"groups\.mlstm\.p\.up"):
        model_params_from_reference(cfg, dict(tree_np, groups=flat_mlstm))
    no_slstm = dict(tree_np, groups={k: v for k, v in groups.items() if k != "slstm"})
    with pytest.raises(KeyError, match=r"groups\.slstm\.p\.w"):
        model_params_from_reference(cfg, no_slstm)


def test_param_shapes_at_full_size_match_reference():
    """xLSTM-1.3B: 1,842,821,456 parameters, shapes as ``jax.eval_shape``
    of the reference init gives them."""
    ref_cfg, cfg = ref_configs.get_config("xlstm-1.3b"), configs.get_config("xlstm-1.3b")
    shapes = jax.eval_shape(lambda k: unbox(ref_build_model(ref_cfg).init(k)), jax.random.PRNGKey(0))
    want = {".".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    model = build_model(cfg)
    assert model.param_shapes() == want
    assert param_count(model.specs()) == sum(int(np.prod(s)) for s in want.values()) == 1_842_821_456
    assert want["groups.mlstm.p.wv"] == (6, 7, 4, 1024, 1024)


def test_reduced_init_draws_every_stacked_layer_apart():
    cfg = configs.get_config("xlstm-1.3b").reduced()
    tree = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    up = tree["groups"]["mlstm"]["p"]["up"]
    assert up.shape[:2] == (2, 1) and not torch.equal(up[0, 0], up[1, 0])
    b = tree["groups"]["slstm"]["p"]["b"]
    assert torch.equal(b[:, 1], torch.full_like(b[:, 1], 2.0)) and torch.equal(b[:, 0], torch.zeros_like(b[:, 0]))
    assert torch.equal(tree["groups"]["mlstm"]["p"]["b_fgate"],
                       torch.full_like(tree["groups"]["mlstm"]["p"]["b_fgate"], 3.0))
