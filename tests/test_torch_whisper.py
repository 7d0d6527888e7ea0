"""The port's encoder–decoder family (Whisper) against the JAX package, on the CPU.

``apply_cross_attn`` and ``apply_cross_attn_cached``, the encoder layer and
the decoder layer's cross branch on the same numpy inputs and weights; the
reduced ``EncDecLM`` (2 encoder and 4 decoder layers, ``enc_seq`` 32) with
random encoder frames, prefill and two decode steps, its self caches and
cross state; greedy serving against the JAX ``ServeEngine``, with each
step's logits as well as the tokens (random weights and the engine's zero
frames decode one token over and over, so equal tokens alone prove
little); ``comm_report`` at tp = 4; the strict conversion of the nested
``dec_layers.xattn``.  The weights are the reference's, carried over by
``convert.model_params_from_reference``.

The JAX side runs its plain path (``use_pallas=False``) at any prompt
length, and its Pallas K3 in interpret mode only at a prompt of at most
128 tokens: its 128-row blocks must divide longer ones.  The port runs
with K3 on (its plain version on the CPU) and off.  Tolerances: fp32 2e-5
for a module and 1e-4 for a model; bf16 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import lm as ref_lm
from repro.models.module import unbox
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import EncDecLM, ParamTree, attention, build_model, lm
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
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _f32(a):
    """A JAX array or a torch tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=what)


def _cfgs(**kw):
    return (dataclasses.replace(ref_configs.get_config("whisper-small").reduced(), **kw),
            dataclasses.replace(configs.get_config("whisper-small").reduced(), **kw))


def _frames(cfg, B, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_cross_attn_matches_reference(cached, dtype):
    """Decoder queries (S = 9) over encoder memory (T = 32): from the
    encoder's output, or from precomputed keys and values."""
    ref_cfg, cfg = _cfgs(dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(21)
    p = _np_tree(unbox(ref_attention.init_cross_attn(jax.random.PRNGKey(4), ref_cfg)))
    B, S, T = 2, 9, cfg.enc_dec.enc_seq
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch_tree(p)
    if cached:
        K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        kv = {n: rng.normal(size=(B, T, K, Dh)).astype(np.float32) for n in ("k", "v")}
        want = ref_attention.apply_cross_attn_cached(
            jp, ref_cfg, jx, {n: jnp.asarray(a).astype(jdt) for n, a in kv.items()})
        got = attention.apply_cross_attn_cached(
            tp, cfg, tx, {n: torch.from_numpy(a).to(tdt) for n, a in kv.items()})
    else:
        enc = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
        want = ref_attention.apply_cross_attn(jp, ref_cfg, jx, jnp.asarray(enc).astype(jdt))
        got = attention.apply_cross_attn(tp, cfg, tx, torch.from_numpy(enc).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    _check(got, want, TOL32 if dtype == "float32" else TOL16, "cross-attention")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encoder_layer_matches_reference(dtype):
    """LayerNorm, bidirectional GQA with no rope, LayerNorm, tanh-GELU MLP."""
    ref_cfg, cfg = _cfgs(dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    p = _np_tree(unbox(ref_lm._init_encoder_layer(jax.random.PRNGKey(5), ref_cfg)))
    rng = np.random.default_rng(22)
    # non-trivial norms: the reference inits scale 1, bias 0
    for ln in ("ln1", "ln2"):
        p[ln] = {k: (v + rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in p[ln].items()}
    x = rng.normal(size=(2, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)
    want = ref_lm._apply_encoder_layer(jax.tree.map(jnp.asarray, p), ref_cfg,
                                       jnp.asarray(x).astype(jdt))
    got = lm._apply_encoder_layer(_torch_tree(p), cfg, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    _check(got, want, TOL32 if dtype == "float32" else TOL16, "encoder layer")


@pytest.mark.parametrize("source", ["enc", "cross_kv"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decoder_layer_cross_branch_matches_reference(source, dtype):
    """A decoder layer with ``xattn`` (causal self-attention, train mode),
    attending to the encoder's output or to its precomputed K/V."""
    ref_cfg, cfg = _cfgs(dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    p = _np_tree(unbox(ref_lm._init_decoder_layer(jax.random.PRNGKey(6), ref_cfg, kind="dense",
                                                  cross=True)))
    assert sorted(p) == sorted(lm._init_decoder_layer(cfg, kind="dense", cross=True))
    rng = np.random.default_rng(23)
    B, S, T = 2, 11, cfg.enc_dec.enc_seq
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch_tree(p)
    jenc, tenc = jnp.asarray(enc).astype(jdt), torch.from_numpy(enc).to(tdt)
    kw_ref, kw = {"enc": jenc}, {"enc": tenc}
    if source == "cross_kv":
        kw_ref = {"cross_kv": {n: jnp.einsum("btd,dhk->bthk", jenc, jp["xattn"][w].astype(jdt))
                               for n, w in (("k", "wk"), ("v", "wv"))}}
        kw = {"cross_kv": {n: attention._project(tenc, tp["xattn"][w].to(tdt))
                           for n, w in (("k", "wk"), ("v", "wv"))}}
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want, _, _ = ref_lm._apply_decoder_layer(jp, ref_cfg, jnp.asarray(x).astype(jdt),
                                             positions=jnp.asarray(pos), cache=None, mode="train",
                                             kind="dense", **kw_ref)
    got, aux = lm._apply_decoder_layer(tp, cfg, torch.from_numpy(x).to(tdt),
                                       positions=torch.from_numpy(pos.copy()), cache=None,
                                       mode="train", kind="dense", **kw)
    assert aux is None  # a dense layer has no MoE aux loss
    assert got.dtype == tdt and got.shape == x.shape
    _check(got, want, TOL32 if dtype == "float32" else TOL16, f"decoder layer ({source})")


# -------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def whisper():
    """Reduced whisper-small in fp32: the reference model and weights, carried over."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build_model(ref_cfg)
    params = unbox(ref_model.init(jax.random.PRNGKey(0)))
    return ref_cfg, cfg, params, model_params_from_reference(cfg, _np_tree(params))


@pytest.mark.parametrize("S,use_pallas,ref_pallas", [
    (41, False, False), (41, True, False),   # ragged: the JAX K3 cannot take it
    (40, True, True),                        # <= 128: the JAX K3 in interpret mode
])
def test_whisper_prefill_and_decode_match_reference(whisper, S, use_pallas, ref_pallas):
    """Random encoder frames, a prefill of S tokens with room for 8 more,
    then two decode steps: logits, self caches and the cross state within
    1e-4."""
    ref_cfg, cfg, params, state = whisper
    ref_model = ref_build_model(dataclasses.replace(ref_cfg, use_pallas=ref_pallas))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    assert isinstance(model, EncDecLM)
    tree = ParamTree.from_state_dict(state)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, S + 2)).astype(np.int32)
    frames = _frames(cfg, 2)
    max_len = S + 8
    want, ref_st = jax.jit(lambda p, b: ref_model.prefill(p, b, max_len=max_len))(
        params, {"tokens": jnp.asarray(toks[:, :S]), "enc_frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got, st = model.prefill(tree, {"tokens": torch.from_numpy(toks[:, :S]).long(),
                                       "enc_frames": torch.from_numpy(frames)}, max_len=max_len)
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        _check(got, want, TOL_MODEL, "prefill")
        cross = {n: a.clone() for n, a in st["cross"].items()}
        step = jax.jit(ref_model.decode_step)
        for i in (S, S + 1):
            want, ref_st = step(params, ref_st, jnp.asarray(toks[:, i:i + 1]))
            got, st = model.decode_step(tree, st, torch.from_numpy(toks[:, i:i + 1]).long())
            _check(got, want, TOL_MODEL, f"decode at {i}")
    assert st["self"].length.tolist() == [S + 2] * cfg.n_layers
    for name, a, b in zip(("k", "v"), st["self"][:2], ref_st["self"][:2]):
        assert tuple(a.shape) == b.shape == (cfg.n_layers, 2, max_len, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
        _check(a, b, TOL_MODEL, f"self cache {name}")
    for name in ("k", "v"):
        a, b = st["cross"][name], ref_st["cross"][name]
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert torch.equal(a, cross[name])  # decode reads the cross state, never writes it
        _check(a, b, TOL_MODEL, f"cross {name}")


def test_whisper_decode_state_matches_reference(whisper):
    ref_cfg, cfg, _, _ = whisper
    mine = build_model(cfg).init_decode_state(3, 20, "cpu")
    ref = ref_build_model(ref_cfg).init_decode_state(3, 20)
    for a, b in zip(mine["self"], ref["self"]):
        assert tuple(a.shape) == b.shape == (cfg.n_layers, *b.shape[1:])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("k", "v"):
        a, b = mine["cross"][name], ref["cross"][name]
        assert tuple(a.shape) == b.shape == (cfg.n_layers, 3, cfg.enc_dec.enc_seq,
                                             cfg.n_kv_heads, cfg.resolved_head_dim)
        assert a.dtype == torch.float32 and not a.any()


class _Logits:
    """The logits every prefill and decode step returns, in order, on either
    side: it wraps the JAX engine's jitted entry points or the port model's."""

    def __init__(self, owner, prefill, decode):
        self.seen = []
        for name in (prefill, decode):
            fn = getattr(owner, name)
            setattr(owner, name, self._watch(fn))

    def _watch(self, fn):
        def call(*args, **kwargs):
            logits, st = fn(*args, **kwargs)
            self.seen.append(_f32(logits))
            return logits, st
        return call


@pytest.mark.parametrize("frames", ["zeros", "random"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_whisper_generate_matches_reference_engine(whisper, frames, use_pallas):
    """Greedy serving of ragged prompts: the same tokens as the JAX engine
    and each step's logits within 1e-4.  ``zeros`` serves the engine's own
    stub frames; ``random`` gives both engines the same random frames.
    max_len = 20 is below enc_seq = 32: encoder frames take no KV slot."""
    ref_cfg, cfg, params, state = whisper
    ecfg = dict(batch_size=3, max_len=20)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), params=params)
    eng = engine.ServeEngine(dataclasses.replace(cfg, use_pallas=use_pallas),
                             engine.EngineConfig(**ecfg), params=state, device="cpu")
    if frames == "random":
        f = _frames(cfg, 3, seed=8)
        ref_eng._extra_inputs = lambda B: {"enc_frames": jnp.asarray(f)}
        eng._extra_inputs = lambda B: {"enc_frames": torch.from_numpy(f)}
    ref_logits = _Logits(ref_eng, "_prefill", "_decode")
    logits = _Logits(eng.model, "prefill", "decode_step")
    lengths = (11, 4, 8)

    def requests(module):
        rng = np.random.default_rng(7)
        return [module.Request(prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32),
                               max_new_tokens=5 - i) for i, n in enumerate(lengths)]

    want = [r.generated for r in ref_eng.generate(requests(ref_engine))]
    served = eng.generate(requests(engine))
    assert [r.generated for r in served] == want and [len(w) for w in want] == [5, 4, 3]
    assert len(logits.seen) == len(ref_logits.seen) == 5
    for i, (a, b) in enumerate(zip(logits.seen, ref_logits.seen)):
        np.testing.assert_allclose(a, b, **TOL_MODEL, err_msg=f"step {i}")
    assert eng.timings["decode_steps"] == 4


def test_whisper_tp_pricing_equals_reference(whisper):
    """``comm_report`` at tp = 4 after serving: 2 · n_layers all-reduces a
    step over the decoder's layers, priced as the reference prices them."""
    ref_cfg, cfg, params, state = whisper
    ecfg = dict(batch_size=2, max_len=32, tp=4)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_engine.EngineConfig(**ecfg), params=params)
    eng = engine.ServeEngine(cfg, engine.EngineConfig(**ecfg), params=state, device="cpu")
    prompts = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
    ref_eng.generate([ref_engine.Request(prompt=p, max_new_tokens=3) for p in prompts])
    eng.generate([engine.Request(prompt=p, max_new_tokens=3) for p in prompts])
    got, want = eng.comm_report(), ref_eng.comm_report()
    assert got["events"] == want["events"] == 2 * cfg.n_layers * 3
    assert got["algorithm"] == want["algorithm"]
    np.testing.assert_allclose(got["sim_comm_s"], want["sim_comm_s"], rtol=1e-12)


# -------------------------------------------------------------- parameters
def test_model_params_from_reference_is_exact_and_strict_on_cross_attention(whisper):
    """``dec_layers.xattn`` and ``enc_layers`` cross over name for name,
    bit for bit; a missing, extra or misshapen leaf raises."""
    _, cfg, params, state = whisper
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(state) and "dec_layers.xattn.wq" in state
    assert "dec_layers.ln_x.bias" in state and "enc_layers.attn.wk" in state
    for name, t in state.items():
        assert np.array_equal(t.numpy(), flat[name]), name
    assert list(state) == list(build_model(cfg).param_shapes())
    tree_np = _np_tree(params)
    dec = tree_np["dec_layers"]
    no_xattn = dict(tree_np, dec_layers={k: v for k, v in dec.items() if k != "xattn"})
    with pytest.raises(KeyError, match=r"dec_layers\.xattn\.wo"):
        model_params_from_reference(cfg, no_xattn)
    extra = dict(tree_np, dec_layers=dict(dec, xattn=dict(dec["xattn"], bogus=np.zeros(3))))
    with pytest.raises(KeyError, match=r"extra \['dec_layers\.xattn\.bogus'\]"):
        model_params_from_reference(cfg, extra)
    one_layer = dict(dec, xattn=dict(dec["xattn"], wq=dec["xattn"]["wq"][0]))  # stacked axis lost
    with pytest.raises(ValueError, match=r"dec_layers\.xattn\.wq"):
        model_params_from_reference(cfg, dict(tree_np, dec_layers=one_layer))


def test_dense_decoder_layers_have_no_cross_branch():
    """The cross branch is the audio decoder's alone: the dense, MoE and VLM
    layers keep their names in their order (and so their init draws)."""
    for arch in ("mistral-large-123b", "olmoe-1b-7b", "internvl2-26b"):
        cfg = configs.get_config(arch).reduced()
        names = list(build_model(cfg).param_shapes())
        assert not any("xattn" in n or "ln_x" in n for n in names), arch
        layer = [n.split(".")[1] for n in names if n.startswith("layers.")]
        assert list(dict.fromkeys(layer)) == ["ln1", "attn", "ln2", "ffn"], arch
