"""The port's decoder family against the JAX package, on the CPU.

``apply_moe`` (grouped and global dispatch, with and without dropped
copies), ``apply_mla`` (train, prefill, absorbed decode) and reduced
``DecoderLM`` models (OLMoE and DeepSeek-V2-Lite: MoE; Mistral-Large:
dense; InternVL2: VLM) on the same numpy inputs, with the reference's
weights carried over by ``convert.model_params_from_reference``.

A top-k pick between two near-tied experts can flip when fp32 sums run in
another order (XLA against torch), and a flip moves that token's output by
about a gate times an expert's output.  So every MoE comparison also counts
the (row, token, layer) triples whose top-k sets differ, prints the count,
and names it in a failure: a failure with no flip is a numeric difference.

Tolerances: fp32 2e-5 for a module and 1e-4 for a model (sums in another
order, through four layers); bf16 2e-2.  The JAX side runs Pallas K3 in
interpret mode where it can take the shape (S = 128); its K3 refuses
InternVL2's 8 image tokens + 128 (136 rows, not a multiple of its 128-row
blocks), so the VLM's oracle is the JAX model's plain path.
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
from repro.models import moe as ref_moe
from repro.models.module import unbox
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import ParamTree, attention, build_model, moe, param_count

TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
TOL16 = dict(rtol=2e-2, atol=2e-2)


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
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def _cfgs(arch, **kw):
    return (dataclasses.replace(ref_configs.get_config(arch).reduced(), **kw),
            dataclasses.replace(configs.get_config(arch).reduced(), **kw))


def _moe_cfgs(arch, capacity, dispatch, dtype="float32"):
    ref, port = _cfgs(arch, dtype=dtype)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity, dispatch=dispatch)) for c in (ref, port))


# ---------------------------------------------------------- routing record
class Routes:
    """The top-k expert ids of every MoE call, on both sides, in call order:
    the reference's through ``jax.lax.top_k`` (a host callback, so it also
    sees the calls inside ``lax.scan`` and ``jit``), the port's through
    ``moe.route``."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        top_k, route = jax.lax.top_k, moe.route

        def ref_top_k(x, k):
            vals, ids = top_k(x, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)), ids, ordered=True)
            return vals, ids

        def port_route(p, cfg, x):
            r = route(p, cfg, x)
            self.port.append(r.experts.cpu().numpy())
            return r

        monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
        monkeypatch.setattr(moe, "route", port_route)

    def flips(self) -> int:
        """(row, token, layer) triples whose top-k expert sets differ."""
        assert len(self.ref) == len(self.port), (len(self.ref), len(self.port))
        n = 0
        for a, b in zip(self.ref, self.port):
            a, b = np.sort(a.reshape(-1, a.shape[-1]), -1), np.sort(b.reshape(-1, b.shape[-1]), -1)
            n += int((a != b).any(-1).sum())
        return n


def _close(got, want, tol, what, routes=None):
    """assert_allclose, naming the routing flips (if any) in a failure."""
    flips = routes.flips() if routes is not None else 0
    if routes is not None:
        print(f"{what}: {flips} routing flips")
    try:
        np.testing.assert_allclose(got, want, **tol)
    except AssertionError as err:
        kind = f"{flips} routing flip(s)" if flips else "a numeric difference (no routing flip)"
        raise AssertionError(f"{what} disagrees with the reference through {kind}:\n{err}") from None


def _keep_of(ids, E, C):
    """The reference's kept-copy mask from its expert ids (G, N, K): a copy
    keeps its slot while fewer than C earlier copies in the flat (N·K) order
    went to its expert (moe.py:76-81)."""
    flat = ids.reshape(ids.shape[0], -1)
    onehot = flat[..., None] == np.arange(E)
    pos = np.take_along_axis(np.cumsum(onehot, axis=1) - 1, flat[..., None], axis=2)[..., 0]
    return pos < C


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
@pytest.mark.parametrize("capacity", [8.0, 1.25])
def test_apply_moe_matches_reference(monkeypatch, arch, dispatch, capacity):
    """At capacity 8.0 (the reduced configs') no copy is dropped; at 1.25
    some are, and the port drops the same ones."""
    ref_cfg, cfg = _moe_cfgs(arch, capacity, dispatch)
    p = _np_tree(unbox(ref_moe.init_moe(jax.random.PRNGKey(3), ref_cfg)))
    p["router"] = p["router"] * 50.0  # logits of std ~1, as a trained router's
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 16, cfg.d_model)).astype(np.float32)
    routes = Routes(monkeypatch)
    want, want_aux = ref_moe.apply_moe(jax.tree.map(jnp.asarray, p), ref_cfg, jnp.asarray(x))
    got, got_aux = moe.apply_moe(_torch_tree(p), cfg, torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), TOL32, f"apply_moe {dispatch} at {capacity}", routes)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), **TOL32)

    G = 3 if dispatch == "grouped" else 1
    xg = torch.from_numpy(x).reshape(G, -1, cfg.d_model)
    r = moe.route(_torch_tree(p), cfg, xg)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    assert r.capacity == max(1, int(np.ceil(xg.shape[1] * K / E * capacity)))
    want_keep = _keep_of(routes.ref[0].reshape(G, -1, K), E, r.capacity)
    assert np.array_equal(r.keep.numpy(), want_keep)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (capacity < E / K), dropped


def test_apply_moe_bf16_matches_reference(monkeypatch):
    ref_cfg, cfg = _moe_cfgs("deepseek-v2-lite-16b", 1.25, "grouped", dtype="bfloat16")
    p = _np_tree(unbox(ref_moe.init_moe(jax.random.PRNGKey(4), ref_cfg)))
    p["router"] = p["router"] * 50.0
    x = np.random.default_rng(9).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    routes = Routes(monkeypatch)
    want, _ = ref_moe.apply_moe(jax.tree.map(jnp.asarray, p), ref_cfg,
                                jnp.asarray(x, jnp.bfloat16))
    got, _ = moe.apply_moe(_torch_tree(p), cfg, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL16, "apply_moe bf16", routes)


# -------------------------------------------------------------------- MLA
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_matches_reference(mode, dtype):
    ref_cfg, cfg = _cfgs("deepseek-v2-lite-16b", dtype=dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    p = _np_tree(unbox(ref_attention.init_mla(jax.random.PRNGKey(5), ref_cfg)))
    rng = np.random.default_rng(10)
    B, T, m = 2, 16, cfg.mla
    S = 1 if mode == "decode" else 12
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if mode == "decode":
        pos = np.full((B, 1), 9, np.int32)
        ck, cr = (rng.normal(size=(B, T, n)).astype(np.float32) for n in (m.kv_lora, m.qk_rope_dim))
        ref_cache = ref_attention.KVCache(jnp.asarray(ck, jdt), jnp.asarray(cr, jdt),
                                          jnp.asarray(9, jnp.int32))
        cache = attention.KVCache(torch.from_numpy(ck).to(tdt), torch.from_numpy(cr).to(tdt),
                                  torch.tensor(9, dtype=torch.int32))
    else:
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        ref_cache = ref_attention.init_mla_cache(B, T, ref_cfg.mla, jdt)
        cache = attention.init_mla_cache(B, T, cfg.mla, tdt)
    use = mode in ("prefill", "decode")
    want, want_cache = ref_attention.apply_mla(
        jax.tree.map(jnp.asarray, p), ref_cfg, jnp.asarray(x, jdt), positions=jnp.asarray(pos),
        cache=ref_cache if use else None, mode=mode)
    got, got_cache = attention.apply_mla(
        _torch_tree(p), cfg, torch.from_numpy(x).to(tdt), positions=torch.from_numpy(pos),
        cache=cache if use else None, mode=mode)
    assert got.dtype == tdt and got.shape == (B, S, cfg.d_model)
    tol = TOL32 if dtype == "float32" else TOL16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    if want_cache is not None:
        assert got_cache is cache  # written in place
        for a, b in zip(got_cache, want_cache):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)
    else:
        assert got_cache is None


# ------------------------------------------------------------------ models
ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "mistral-large-123b", "internvl2-26b"]


@pytest.fixture(scope="module")
def reference():
    """Reduced fp32 reference models and weights, carried over; per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg, cfg = _cfgs(arch)
            ref_model = ref_build_model(ref_cfg)
            params = unbox(ref_model.init(jax.random.PRNGKey(0)))
            cache[arch] = (ref_cfg, cfg, params, model_params_from_reference(cfg, _np_tree(params)))
        return cache[arch]

    return get


def _prompt_batch(cfg, S, seed=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(2, S + 2)).astype(np.int32)
    img = (rng.normal(size=(2, cfg.vlm.n_img_tokens, cfg.d_model)).astype(np.float32)
           if cfg.vlm else None)
    return toks, img


@pytest.mark.parametrize("arch,use_pallas,ref_pallas", [
    ("olmoe-1b-7b", False, False), ("olmoe-1b-7b", True, True),
    ("deepseek-v2-lite-16b", False, False),
    ("mistral-large-123b", False, False), ("mistral-large-123b", True, True),
    ("internvl2-26b", False, False), ("internvl2-26b", True, False),
])
def test_decoder_prefill_and_decode_match_reference(monkeypatch, reference, arch, use_pallas,
                                                    ref_pallas):
    """Prefill of 128 tokens (after 8 image tokens for the VLM), then two
    decode steps; logits within 1e-4."""
    ref_cfg, cfg, params, state = reference(arch)
    ref_model = ref_build_model(dataclasses.replace(ref_cfg, use_pallas=ref_pallas))
    model = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
    tree = ParamTree.from_state_dict(state)
    S = 128
    toks, img = _prompt_batch(cfg, S)
    ref_batch, batch = {"tokens": jnp.asarray(toks[:, :S])}, {"tokens": torch.from_numpy(toks[:, :S]).long()}
    if img is not None:
        ref_batch["img_embeds"], batch["img_embeds"] = jnp.asarray(img), torch.from_numpy(img)
    routes = Routes(monkeypatch) if cfg.moe else None
    want, ref_st = jax.jit(ref_model.prefill)(params, ref_batch)
    with torch.inference_mode():
        got, st = model.prefill(tree, batch)
        assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got.numpy(), np.asarray(want), TOL_MODEL, f"{arch} prefill", routes)
        step = jax.jit(ref_model.decode_step)
        for i in (S, S + 1):
            want, ref_st = step(params, ref_st, jnp.asarray(toks[:, i:i + 1]))
            got, st = model.decode_step(tree, st, torch.from_numpy(toks[:, i:i + 1]).long())
            _close(got.numpy(), np.asarray(want), TOL_MODEL, f"{arch} decode at {i}", routes)
    n_img = cfg.vlm.n_img_tokens if cfg.vlm else 0
    assert st.length.tolist() == [n_img + S + 2] * cfg.n_layers
    for a, b in zip(st[:2], ref_st[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_MODEL)


def test_model_params_from_reference_is_exact_and_strict_on_shared_experts(reference):
    ref_cfg, cfg, params, state = reference("deepseek-v2-lite-16b")
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(state)
    assert {"layers.ffn.shared.0.wi_gate", "layers.ffn.shared.1.wo", "front_0.ffn.wi_gate",
            "layers.attn.w_uk"} <= set(state)
    for name, t in state.items():
        assert np.array_equal(t.numpy(), flat[name]), name
    tree = ParamTree.from_state_dict(state)
    shared = tree["layers"]["ffn"]["shared"]
    assert shared.is_list and len(shared) == 2
    assert [id(s) for s in shared] == [id(shared[0]), id(shared[1])]  # in order
    assert torch.equal(shared[1]["wi_up"], torch.from_numpy(flat["layers.ffn.shared.1.wi_up"]))
    assert set(tree.state_dict()) == set(state)

    tree_np = _np_tree(params)
    ffn = tree_np["layers"]["ffn"]
    one_shared = dict(tree_np, layers=dict(tree_np["layers"], ffn=dict(ffn, shared=ffn["shared"][:1])))
    with pytest.raises(KeyError, match=r"layers\.ffn\.shared\.1\.wi_gate"):
        model_params_from_reference(cfg, one_shared)
    three = dict(tree_np, layers=dict(tree_np["layers"],
                                      ffn=dict(ffn, shared=ffn["shared"] + ffn["shared"][:1])))
    with pytest.raises(KeyError, match="extra"):
        model_params_from_reference(cfg, three)
    bad = [dict(ffn["shared"][0], wo=np.zeros((3, 3), np.float32)), ffn["shared"][1]]
    wrong = dict(tree_np, layers=dict(tree_np["layers"], ffn=dict(ffn, shared=bad)))
    with pytest.raises(ValueError, match=r"layers\.ffn\.shared\.0\.wo"):
        model_params_from_reference(cfg, wrong)


def test_published_parameter_counts():
    """OLMoE-1B-7B: 6.919 B parameters; DeepSeek-V2-Lite cut to 4 layers
    (the served depth): 2.255 B."""
    olmoe = build_model(configs.get_config("olmoe-1b-7b"))
    assert round(param_count(olmoe.specs()) / 1e9, 3) == 6.919
    ds = build_model(dataclasses.replace(configs.get_config("deepseek-v2-lite-16b"), n_layers=4))
    assert round(param_count(ds.specs()) / 1e9, 3) == 2.255
