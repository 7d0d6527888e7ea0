"""The port's model substrate against the JAX package, on the CPU.

Configs field for field; layers, GQA attention and Mamba-2 on the same
numpy inputs and weights; reduced Zamba2's prefill and decode logits with
weights carried over by ``convert.model_params_from_reference``.  The JAX
side runs its plain path (``use_pallas=False``): its Pallas SSD refuses the
zero initial state the model hands it (ROADMAP Queue 3).  Tolerances: fp32
2e-5 for a layer and 1e-4 for the whole model (sums in another order,
through four layers); bf16 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import (
    attention as ref_attention,
    build_model as ref_build_model,
    layers as ref_layers,
    ssm as ref_ssm,
)
from repro.models.module import unbox
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import (
    DecoderLM,
    EncDecLM,
    ParamTree,
    XLSTMLM,
    attention,
    build_model,
    layers,
    param_count,
    ssm,
)

TOL32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison.  In a fresh process
    with several OpenMP threads, the first batched MKL product on the CPU
    can come out wrong (observed with torch 2.13.0+cpu: errors near 1e-4 in
    the first ``ssd_reference`` call, none once a plain matmul has run)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _random_tree(rng, shapes, scale=0.3):
    """Nested numpy weights of the given nested shapes."""
    return {k: _random_tree(rng, v, scale) if isinstance(v, dict)
            else (rng.normal(size=v) * scale).astype(np.float32) for k, v in shapes.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(ref_configs._MODULES))
def test_configs_equal_reference(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    for a, b in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.resolved_head_dim == b.resolved_head_dim
        assert a.sub_quadratic == b.sub_quadratic
        want = torch.bfloat16 if a.act_dtype() == jnp.bfloat16 else torch.float32
        assert b.act_dtype() == want
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.SHAPES == {k: configs.ShapeConfig(**dataclasses.asdict(v))
                              for k, v in ref_configs.SHAPES.items()}


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(norm_type):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32) + 1.0,
         "bias": rng.normal(size=32).astype(np.float32)}
    want = ref_layers.apply_norm(_jax_tree(p), jnp.asarray(x), eps=1e-5, norm_type=norm_type)
    got = layers.apply_norm(_torch_tree(p), _t(x), eps=1e-5, norm_type=norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("style", ["full", "chatglm_2d", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(style, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [5]])).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = ref_layers.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), style=style)
    got = layers.apply_rope(_t(x).to(tdt), torch.from_numpy(pos), style=style)
    assert got.dtype == tdt
    tol = TOL32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_apply_mlp_matches_reference(mlp_type):
    """gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 2.0
    shapes = {k: tuple(v) for k, v in {"wi_gate": (16, 24), "wi_up": (16, 24), "wi": (16, 24),
                                        "wo": (24, 16)}.items()}
    p = _random_tree(rng, shapes)
    want = ref_layers.apply_mlp(_jax_tree(p), jnp.asarray(x), mlp_type=mlp_type)
    got = layers.apply_mlp(_torch_tree(p), _t(x), mlp_type=mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    if mlp_type == "gelu":  # the exact erf gelu would be off by more than the tolerance
        exact = torch.nn.functional.gelu(_t(x) @ _t(p["wi"])) @ _t(p["wo"])
        assert not np.allclose(exact.numpy(), np.asarray(want), **TOL32)


def test_embed_logits_and_positions_match_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    want = ref_layers.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.bfloat16)
    got = layers.embed_lookup(_t(table), torch.from_numpy(ids).long(), torch.bfloat16)
    assert torch.equal(got.float(), torch.from_numpy(np.asarray(want, np.float32)))
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(layers.logits_projection(_t(table), _t(x)).numpy(),
                               np.asarray(ref_layers.logits_projection(jnp.asarray(table),
                                                                       jnp.asarray(x))), **TOL32)
    np.testing.assert_allclose(layers.sinusoidal_positions(9, 12).numpy(),
                               np.asarray(ref_layers.sinusoidal_positions(9, 12)), **TOL32)


# ---------------------------------------------------------------- attention
def _gqa_cfg(use_pallas, impl):
    ref = dataclasses.replace(ref_configs.get_config("chatglm3-6b").reduced(), n_kv_heads=2,
                              attention_impl=impl)
    port = dataclasses.replace(configs.get_config("chatglm3-6b").reduced(), n_kv_heads=2,
                               use_pallas=use_pallas, attention_impl=impl)
    return ref, port


@pytest.mark.parametrize("mode,use_pallas,impl", [
    ("train", False, "full"), ("train", True, "full"), ("train", False, "blocked"),
    ("prefill", False, "full"), ("prefill", True, "full"), ("prefill", False, "blocked"),
    ("decode", False, "full"), ("bidir", False, "full"),
])
def test_apply_gqa_matches_reference(mode, use_pallas, impl):
    ref_cfg, cfg = _gqa_cfg(use_pallas, impl)
    rng = np.random.default_rng(4)
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = _random_tree(rng, {"wq": (d, H, Dh), "wk": (d, K, Dh), "wv": (d, K, Dh),
                           "wo": (H, Dh, d)}, scale=0.2)
    B, T = 2, 16
    S = 1 if mode == "decode" else 12
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if mode == "decode":
        pos = np.full((B, 1), 9, np.int32)
        k0, v0 = (rng.normal(size=(B, T, K, Dh)).astype(np.float32) for _ in range(2))
        ref_cache = ref_attention.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(9, jnp.int32))
        cache = attention.KVCache(_t(k0), _t(v0), torch.tensor(9, dtype=torch.int32))
    else:
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        ref_cache = ref_attention.init_cache(B, T, K, Dh, Dh, jnp.float32)
        cache = attention.init_cache(B, T, K, Dh, Dh, torch.float32)
    want, want_cache = ref_attention.apply_gqa(
        _jax_tree(p), ref_cfg, jnp.asarray(x), positions=jnp.asarray(pos),
        cache=ref_cache if mode in ("prefill", "decode") else None, mode=mode)
    got, got_cache = attention.apply_gqa(
        _torch_tree(p), cfg, _t(x), positions=torch.from_numpy(pos),
        cache=cache if mode in ("prefill", "decode") else None, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    if want_cache is not None:
        for a, b in zip(got_cache, want_cache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL32)


# ------------------------------------------------------------------ Mamba-2
def test_apply_mamba2_prefill_then_decode_matches_reference():
    ref_cfg = ref_configs.get_config("zamba2-2.7b").reduced()
    cfg = configs.get_config("zamba2-2.7b").reduced()
    rng = np.random.default_rng(5)
    p = _np_tree(unbox(ref_ssm.init_mamba2(jax.random.PRNGKey(1), ref_cfg)))
    p["dt_bias"] = p["dt_bias"] + rng.normal(size=p["dt_bias"].shape).astype(np.float32) * 8
    B, S = 2, 21
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ref_state = ref_ssm.init_mamba2_state(ref_cfg, B, jnp.float32)
    state = ssm.init_mamba2_state(cfg, B, torch.float32)
    want, want_st = ref_ssm.apply_mamba2(_jax_tree(p), ref_cfg, jnp.asarray(x[:, :-1]),
                                         state=ref_state, mode="prefill")
    for use_pallas in (False, True):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        got, st = ssm.apply_mamba2(_torch_tree(p), c, _t(x[:, :-1]), state=state, mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
        for a, b in zip(st, want_st):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL32)
    want, want_st = ref_ssm.apply_mamba2(_jax_tree(p), ref_cfg, jnp.asarray(x[:, -1:]),
                                         state=want_st, mode="decode")
    got, st = ssm.apply_mamba2(_torch_tree(p), cfg, _t(x[:, -1:]), state=st, mode="decode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    for a, b in zip(st, want_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL32)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want, rtol=1e-6, atol=0)


# -------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def zamba2():
    """Reduced Zamba2 in fp32: the reference model and weights, carried over."""
    ref_cfg = ref_configs.get_config("zamba2-2.7b").reduced()
    cfg = configs.get_config("zamba2-2.7b").reduced()
    ref_model = ref_build_model(ref_cfg)
    params = unbox(ref_model.init(jax.random.PRNGKey(0)))
    state = model_params_from_reference(cfg, _np_tree(params))
    return ref_cfg, cfg, ref_model, params, state


@pytest.mark.parametrize("use_pallas", [False, True])
def test_zamba2_prefill_and_decode_match_reference(zamba2, use_pallas):
    ref_cfg, cfg, ref_model, params, state = zamba2
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    model = build_model(cfg)
    tree = ParamTree.from_state_dict(state)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 27)).astype(np.int32)
    want, ref_st = jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(toks[:, :25])})
    with torch.inference_mode():
        got, st = model.prefill(tree, {"tokens": torch.from_numpy(toks[:, :25]).long()})
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        step = jax.jit(ref_model.decode_step)
        for i in (25, 26):
            want, ref_st = step(params, ref_st, jnp.asarray(toks[:, i:i + 1]))
            got, st = model.decode_step(tree, st, torch.from_numpy(toks[:, i:i + 1]).long())
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert int(st["attn"].length[0]) == 27


def test_model_params_from_reference_is_exact_and_strict(zamba2):
    ref_cfg, cfg, ref_model, params, state = zamba2
    flat = {_path_name(path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(state) and "mamba.p.in_proj" in state and "shared.attn.wq" in state
    for name, t in state.items():
        assert np.array_equal(t.numpy(), flat[name]), name
    assert list(state) == list(build_model(cfg).param_shapes())
    tree = ParamTree.from_state_dict(state)
    assert list(tree.state_dict()) == list(state)
    bf = model_params_from_reference(cfg, jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params))
    assert bf["embed"].dtype == torch.bfloat16
    assert np.array_equal(bf["embed"].view(torch.int16).numpy(),
                          np.asarray(params["embed"].astype(jnp.bfloat16)).view(np.int16))
    tree_np = _np_tree(params)
    missing = dict(tree_np, shared={k: v for k, v in tree_np["shared"].items() if k != "ffn"})
    with pytest.raises(KeyError, match="shared.ffn.wi"):
        model_params_from_reference(cfg, missing)
    with pytest.raises(KeyError, match="extra"):
        model_params_from_reference(cfg, dict(tree_np, bogus=np.zeros(3)))
    wrong = dict(tree_np, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        model_params_from_reference(cfg, wrong)


def _path_name(path):
    """A reference tree path as a ``state_dict`` key: dict keys and list
    indices (DeepSeek's shared experts) joined by ``.``."""
    return ".".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)


def test_init_shapes_and_param_count_match_reference():
    for arch in ("zamba2-2.7b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "mistral-large-123b",
                 "internvl2-26b", "whisper-small"):
        ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
        shapes = jax.eval_shape(lambda k: unbox(ref_build_model(ref_cfg).init(k)), jax.random.PRNGKey(0))
        want = {_path_name(path): tuple(v.shape)
                for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
        assert build_model(cfg).param_shapes() == want, arch
        if arch == "whisper-small":  # 12 encoder and 12 decoder layers with cross-attention
            assert param_count(build_model(cfg).specs()) == 277_940_736
            assert want["dec_layers.xattn.wq"] == (12, 768, 12, 64)
    small = configs.get_config("zamba2-2.7b").reduced()
    tree = build_model(small).init(torch.Generator().manual_seed(0), device="cpu")
    assert param_count(tree) == param_count(build_model(small).specs())
    w = tree["mamba"]["p"]["in_proj"]
    assert w.shape[0] == small.n_layers and w.abs().max() <= 2.0 / np.sqrt(small.d_model) + 1e-6
    assert torch.equal(tree["mamba"]["p"]["D"], torch.ones_like(tree["mamba"]["p"]["D"]))


def test_entry_points_default_to_cuda_and_other_families_raise():
    for arch in ("zamba2-2.7b", "olmoe-1b-7b", "xlstm-1.3b", "whisper-small"):
        cfg = configs.get_config(arch).reduced()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(cfg).init(torch.Generator())
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(cfg).init_decode_state(1, 8)
    for arch in ("mistral-large-123b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "internvl2-26b"):
        assert isinstance(build_model(configs.get_config(arch)), DecoderLM), arch
    assert isinstance(build_model(configs.get_config("xlstm-1.3b")), XLSTMLM)
    assert isinstance(build_model(configs.get_config("whisper-small")), EncDecLM)
    unknown = dataclasses.replace(configs.get_config("whisper-small"), family="video")
    with pytest.raises(NotImplementedError, match="not one the reference defines"):
        build_model(unknown)
