"""Training in the port against the JAX package, on the CPU.

The data pipeline's batches (bit-equal), the learning-rate schedules, AdamW
on identical gradients, ``loss`` and every parameter's gradient for each
model family under each remat mode, the microbatched train step over three
steps, the data-parallel step through PCCL's planned all-reduce, and the
gradient of K3's and K4's entry points (:class:`PlainGradient`, the
plain version's autograd) against direct autograd.  The same numpy inputs
and the reference's weights (``convert.model_params_from_reference``) go to
both sides.

The JAX side runs its plain path (``use_pallas=False``): it cannot
differentiate its Pallas kernels (``jax.grad`` through ``pallas_call``
fails on JAX 0.9.0), so its plain path is the oracle of every gradient.
AdamW's update is about ``sign(g)·lr`` where ``|g|`` is tiny, so a
gradient that differs by an ulp near zero can flip a parameter's step: the
optimizer is held on identical gradients, and training over several steps
by its losses and each step's gradients.  Tolerances: the pipeline bit for
bit; the schedule and AdamW 1e-6 relative (fp32 in another order); loss
1e-5 and gradients 1e-4 abs / 1e-3 rel (sums in another order through a
whole model and its backward pass); the microbatched steps' losses 1e-4
relative; the data-parallel step 1e-5; the kernel Functions bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.api import PcclSession as RefSession
from repro.comm import primitives as ref_prims
from repro.core import cost_model as ref_cm
from repro.data import pipeline as ref_pipeline
from repro.kernels.ssd import ref as ref_ssd
from repro.models import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_train_step
from repro_torch import configs
from repro_torch.api import PcclSession
from repro_torch.convert import model_params_from_reference, opt_state_from_reference
from repro_torch.core import cost_model as cm
from repro_torch.data import pipeline
from repro_torch.kernels.autograd import PlainGradient
from repro_torch.kernels.flash import attention_reference, flash_attention
from repro_torch.kernels.ssd import ssd, ssd_decode_step, ssd_reference
from repro_torch.models import ParamTree, build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import dp_gradients, make_dp_train_step, make_train_step

TOL_LOSS = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-3, atol=1e-4)
REMATS = ("full", "dots", "none")
# one arch per kind of model the reference trains
FAMILIES = {"dense": "mistral-large-123b", "moe": "olmoe-1b-7b", "vlm": "internvl2-26b",
            "mla": "deepseek-v2-lite-16b", "hybrid": "zamba2-2.7b", "ssm": "xlstm-1.3b",
            "audio": "whisper-small"}
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison (see
    tests/test_torch_models.py: the first batched MKL product of a fresh
    process can come out wrong)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (dataclasses.replace(ref_configs.get_config(arch).reduced(), **kw),
            dataclasses.replace(configs.get_config(arch).reduced(), **kw))


def _batch(cfg, rows, seq=SEQ, step=0, seed=0):
    data = pipeline.SyntheticLMData(cfg, pipeline.DataConfig(global_batch=rows, seq_len=seq,
                                                             seed=seed))
    return data.global_batch(step)


def _nest(flat):
    """The reference's nested dicts (and lists, where the names are 0 … n-1)
    of a flat ``{"a.b.c": array}``."""
    nested = {}
    for key, value in flat.items():
        node = nested
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        return list(node.values()) if list(node) == [str(i) for i in range(len(node))] else node

    return lists(nested)


def _weights(cfg, seed=0):
    """Random weights of ``cfg``'s model as the reference's numpy tree, drawn
    by the port's initializers (the reference's eager init compiles every
    draw anew, seconds a model)."""
    params = build_model(cfg).init(torch.Generator().manual_seed(seed), "cpu")
    return _nest({k: v.numpy() for k, v in params.state_dict().items()})


def _flat(tree, prefix=""):
    """``{"a.b.c": leaf}`` of the reference's nested dicts and lists."""
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("arch", ["chatglm3-6b", "internvl2-26b", "whisper-small"])
def test_pipeline_batches_bit_equal(arch):
    """Dense tokens, the VLM's image embeddings, the encoder's frames: every
    host's shard and the global batch, several steps, and the prefetching
    iterator."""
    ref_cfg, cfg = _cfgs(arch)
    dc = dict(global_batch=4, seq_len=24, seed=7, n_hosts=2)
    ref = ref_pipeline.SyntheticLMData(ref_cfg, ref_pipeline.DataConfig(**dc))
    port = pipeline.SyntheticLMData(cfg, pipeline.DataConfig(**dc))
    for step in (0, 1, 5):
        for host in (0, 1):
            want, got = ref.host_batch(step, host), port.host_batch(step, host)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    it = port.iterate(start_step=3)
    for step in (3, 4):
        got, want = next(it), ref.global_batch(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    it.close()
    t = pipeline.to_device(port.global_batch(0), "cpu")
    assert t["tokens"].dtype == torch.int32 and t["tokens"].shape[0] == 4


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 100])
def test_learning_rate_matches_reference(schedule, warmup):
    cfg = dict(schedule=schedule, warmup_steps=warmup, total_steps=1000, lr=3e-4)
    steps = np.array([0, 1, 7, 99, 100, 101, 500, 999, 1000, 2000], np.int32)
    want = [float(ref_opt.learning_rate(ref_opt.OptimizerConfig(**cfg), jnp.int32(s))) for s in steps]
    got = [float(opt.learning_rate(opt.OptimizerConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference_on_identical_gradients(clip):
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    mu = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    nu = {k: rng.random(size=s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    kw = dict(lr=1e-2, grad_clip=clip, warmup_steps=3, total_steps=50)
    ref_state = ref_opt.OptState(jnp.int32(4), jax.tree.map(jnp.asarray, mu),
                                 jax.tree.map(jnp.asarray, nu))
    want_p, want_s, want_m = ref_opt.adamw_update(
        ref_opt.OptimizerConfig(**kw), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, params), ref_state)
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}  # noqa: E731
    state = opt.OptState(torch.tensor(4, dtype=torch.int32), t(mu), t(nu))
    got_p, got_s, got_m = opt.adamw_update(opt.OptimizerConfig(**kw), t(grads), t(params), state)
    assert int(got_s.step) == int(want_s.step) == 5
    for k in shapes:
        for got, want in ((got_p[k], want_p[k]), (got_s.mu[k], want_s.mu[k]),
                          (got_s.nu[k], want_s.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6)
    clipped = float(want_m["grad_norm"]) > clip
    assert clipped == (clip == 0.5)
    g, norm = opt.clip_by_global_norm(t(grads), clip)
    np.testing.assert_allclose(float(norm), float(want_m["grad_norm"]), rtol=1e-6)
    assert float(opt.global_norm(g)) == pytest.approx(min(clip, float(norm)), rel=1e-6)


def test_adamw_update_in_chunks_is_elementwise(monkeypatch):
    """The in-place update in chunks gives the bits of one whole-tensor pass."""
    rng = np.random.default_rng(4)
    p = {"w": torch.from_numpy(rng.normal(size=(37, 11)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.normal(size=(37, 11)).astype(np.float32))}
    cfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=0)
    whole = {"w": p["w"].clone()}
    _, s1, _ = opt.adamw_update(cfg, g, whole, opt.init_opt_state(whole))
    monkeypatch.setattr(opt, "CHUNK", 10)
    chunked = {"w": p["w"].clone()}
    _, s2, _ = opt.adamw_update(cfg, g, chunked, opt.init_opt_state(chunked))
    assert torch.equal(whole["w"], chunked["w"]) and torch.equal(s1.nu["w"], s2.nu["w"])


# ---------------------------------------------------------- loss and grads
@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch):
    """The reference's loss and gradients of reduced ``arch`` (plain path)
    on a pipeline batch of 2 × 32, and its weights as numpy."""
    ref_cfg, cfg = _cfgs(arch)
    ref_model = ref_build_model(ref_cfg)
    params = _weights(cfg)
    batch = _batch(ref_cfg, 2)
    loss_fn = lambda p: ref_model.loss(p, jax.tree.map(jnp.asarray, batch))[0]  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return params, batch, float(loss), _flat(_np_tree(grads))


def _port_model(arch, **kw):
    _, cfg = _cfgs(arch, **kw)
    return cfg, build_model(cfg)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family, remat):
    arch = FAMILIES[family]
    params_np, batch, want_loss, want_grads = _reference_loss_and_grads(arch)
    cfg, model = _port_model(arch, remat=remat)
    params = ParamTree.from_state_dict(model_params_from_reference(cfg, params_np))
    params.requires_grad_(True)
    loss, metrics = model.loss(params, pipeline.to_device(batch, "cpu"))
    assert "xent" in metrics and loss.dtype == torch.float32 and loss.ndim == 0
    names = [k for k, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in params.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), want_loss, **TOL_LOSS)
    assert sorted(names) == sorted(want_grads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], **TOL_GRAD, err_msg=name)


def test_remat_modes_give_the_same_gradients_and_serving_is_untouched():
    """The three remat modes differ in what they save, not in what they
    compute; parameters that take gradients still serve in inference mode.
    (``torch.matmul`` folds a 3-D by 2-D product into one matmul only when
    the 2-D operand takes no gradient, so the logits move by an ulp.)"""
    cfg, model = _port_model("zamba2-2.7b")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = pipeline.to_device(_batch(cfg, 2), "cpu")
    with torch.inference_mode():
        before, _ = model.prefill(params, {"tokens": batch["tokens"].long()})
    grads = {}
    for remat in REMATS:
        m = build_model(dataclasses.replace(cfg, remat=remat))
        params.requires_grad_(True)
        loss, _ = m.loss(params, batch)
        grads[remat] = torch.autograd.grad(loss, list(params.parameters()))
    for remat in ("dots", "none"):
        for a, b in zip(grads["full"], grads[remat]):
            assert torch.equal(a, b)
    with torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": batch["tokens"].long()})
    assert not logits.requires_grad
    torch.testing.assert_close(logits, before, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Three steps of the microbatched train step from the same weights and
    a fresh AdamW state: each step's loss within 1e-4 relative."""
    ref_cfg, cfg = _cfgs("zamba2-2.7b")
    ref_model = ref_build_model(ref_cfg)
    ref_params = _weights(cfg, seed=1)
    params = ParamTree.from_state_dict(model_params_from_reference(cfg, ref_params))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_step = jax.jit(ref_train_step.make_train_step(ref_model, ref_opt.OptimizerConfig(**kw),
                                                      microbatches=microbatches))
    step = make_train_step(build_model(cfg), opt.OptimizerConfig(**kw), microbatches=microbatches)
    ref_state, state = ref_opt.init_opt_state(ref_params), opt.init_opt_state(params)
    for i in range(3):
        batch = _batch(cfg, 4, step=i)
        ref_params, ref_state, want = ref_step(ref_params, ref_state,
                                               jax.tree.map(jnp.asarray, batch))
        params, state, got = step(params, state, pipeline.to_device(batch, "cpu"))
        assert set(got) == set(want)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(got["xent"]), float(want["xent"]), rtol=1e-4)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
        assert int(state.step) == i + 1
    assert all(p.grad is None for p in params.parameters())  # dropped after each update


# --------------------------------------------------- data-parallel step
def _dp_cfgs():
    """The widened chatglm3-6b of examples/pccl_dp_training.py at
    ``--d-model 64 --layers 2``."""
    kw = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=4 * 64,
              vocab=32000, dtype="float32")
    return _cfgs("chatglm3-6b", **kw)


def _reference_dp_step(ref_model, ref_comm, opt_cfg, params, state, batch, n):
    """Per-rank ``jax.value_and_grad``; each leaf's rank-stacked gradients
    all-reduced by the reference's per-round interpreter under vmap, on the
    plan the communicator picks for the padded flat leaf; ``/ n``; AdamW."""
    b = batch["tokens"].shape[0] // n
    vg = jax.jit(jax.value_and_grad(lambda p, t: ref_model.loss(p, {"tokens": t})[0]))
    losses, per_rank = [], []
    for r in range(n):
        loss, g = vg(params, jnp.asarray(batch["tokens"][r * b:(r + 1) * b]))
        losses.append(float(loss))
        per_rank.append(g)
    stacked = jax.tree.map(lambda *gs: jnp.stack(gs), *per_rank)

    def all_reduce(x):
        flat = x.reshape(n, -1)
        pad = (-flat.shape[1]) % n
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
        sched = ref_comm.axis_schedule("all_reduce", flat.shape[1] * 4.0)
        red = jax.vmap(lambda xl: ref_prims.run_reference("all_reduce", xl, sched, "x"),
                       axis_name="x")(flat)
        return red[:, :flat.shape[1] - pad].reshape(x.shape)

    reduced = jax.tree.map(all_reduce, stacked)
    grads = jax.tree.map(lambda g: g[0] / n, reduced)
    params, state, _ = ref_opt.adamw_update(opt_cfg, grads, params, state)
    return sum(losses) / n, _flat(_np_tree(reduced)), params, state


def test_dp_train_step_matches_reference():
    """n = 4 ranks, 2 steps: each step's loss and all-reduced gradients
    within 1e-5 of the JAX oracle, every rank's row of the all-reduce bit
    for bit the same.  Both sides start each step from the reference's
    weights and AdamW state (``opt_state_from_reference``)."""
    n = 4
    ref_cfg, cfg = _dp_cfgs()
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    kw = dict(lr=1e-3, total_steps=2, warmup_steps=10)
    ref_params = jax.tree.map(jnp.asarray, _weights(cfg))
    ref_state = ref_opt.init_opt_state(ref_params)
    ref_comm = RefSession(ref_cm.H100_DGX).communicator("x", n)
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", n)
    step = make_dp_train_step(model, opt.OptimizerConfig(**kw), comm, n)
    data = pipeline.SyntheticLMData(cfg, pipeline.DataConfig(global_batch=8, seq_len=16))
    for i in range(2):
        params = ParamTree.from_state_dict(model_params_from_reference(cfg, _np_tree(ref_params)))
        state = opt_state_from_reference(cfg, _np_tree(ref_state))
        assert int(state.step) == i
        batch = data.global_batch(i)
        want_loss, want_red, ref_params, ref_state = _reference_dp_step(
            ref_model, ref_comm, ref_opt.OptimizerConfig(**kw), ref_params, ref_state, batch, n)
        tb = pipeline.to_device(batch, "cpu")
        losses, reduced = dp_gradients(model, params, tb, comm, n)
        for name, red in reduced.items():
            assert all(torch.equal(red[r], red[0]) for r in range(1, n)), name
            np.testing.assert_allclose(red.numpy(), want_red[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        params, state, got = step(params, state, tb)
        np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(losses.mean()), want_loss, rtol=1e-5, atol=1e-5)
        assert int(state.step) == i + 1


def test_dp_gradients_mean_equals_the_full_batch_gradient():
    """The ranks' all-reduced mean gradient is the full batch's (equal
    rows a rank), and the ranks' mean loss the full batch's loss."""
    n = 4
    _, cfg = _dp_cfgs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", n)
    batch = pipeline.to_device(_batch(cfg, 8, seq=16), "cpu")
    losses, reduced = dp_gradients(model, params, batch, comm, n)
    loss, _ = model.loss(params, batch)
    full = dict(zip([k for k, _ in params.named_parameters()],
                    torch.autograd.grad(loss, list(params.parameters()))))
    np.testing.assert_allclose(float(losses.mean()), float(loss.detach()), rtol=1e-6)
    for name, red in reduced.items():
        torch.testing.assert_close(red[0] / n, full[name], rtol=1e-4, atol=1e-6)


# ------------------------------------------------- the kernels' gradients
def _grads(fn, inputs, weights):
    """Gradients of Σ out·w over the outputs that have a weight."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * w).sum() for o, w in zip(outs, weights) if w is not None)
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    return torch.autograd.grad(total, wrt)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_equals_direct_autograd(causal, dtype):
    """K3's Function with the plain version as its forward: its backward
    gives direct autograd's bits (GQA 4:1, ragged S)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 37, h, 16, generator=g).to(dtype).requires_grad_()
               for h in (8, 2, 2))
    w = [torch.randn(2, 37, 8, 16, generator=g)]
    kw = {"causal": causal}
    fn = lambda *t: PlainGradient.apply(attention_reference, attention_reference, kw, *t)  # noqa: E731
    got = _grads(fn, (q, k, v), w)
    want = _grads(lambda *t: attention_reference(*t, **kw), (q, k, v), w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the CPU entry point is the plain version, differentiated directly
    assert all(torch.equal(a, b) for a, b in
               zip(_grads(lambda *t: flash_attention(*t, **kw), (q, k, v), w), want))


def _ssd_plain(X, la, Bm, Cm, init, *, chunk):
    return ssd_reference(X, la, Bm, Cm, chunk=chunk, initial_state=init)


@pytest.mark.parametrize("case", ["shared", "per_head", "initial_state", "final_state_unused"])
def test_ssd_function_backward_equals_direct_autograd(case):
    """K4's Function with the plain version as its forward: shared B/C
    (whose gradient sums over heads), per-head B/C, an initial state that
    takes a gradient, and a final state nobody reads (no gradient reaches
    it) give direct autograd's bits."""
    g = torch.Generator().manual_seed(1)
    B, S, H, P, N = 2, 40, 3, 8, 4
    bc = (B, S, H, N) if case != "shared" else (B, S, N)
    X = torch.randn(B, S, H, P, generator=g).requires_grad_()
    la = (-torch.rand(B, S, H, generator=g) * 0.3).requires_grad_()
    Bm, Cm = ((torch.randn(*bc, generator=g) * 0.3).requires_grad_() for _ in range(2))
    init = None
    if case == "initial_state":
        init = (torch.randn(B, H, P, N, generator=g) * 0.1).requires_grad_()
    w = [torch.randn(B, S, H, P, generator=g),
         None if case == "final_state_unused" else torch.randn(B, H, P, N, generator=g)]
    kw = {"chunk": 16}
    inputs = (X, la, Bm, Cm, init)
    fn = lambda *t: PlainGradient.apply(_ssd_plain, _ssd_plain, kw, *t)  # noqa: E731
    got = _grads(fn, inputs, w)
    want = _grads(lambda *t: _ssd_plain(*t, **kw), inputs, w)
    assert len(got) == (5 if init is not None else 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cpu = _grads(lambda X, la, Bm, Cm, init: ssd(X, la, Bm, Cm, chunk=16, initial_state=init),
                 inputs, w)
    assert all(torch.equal(a, b) for a, b in zip(cpu, want))


def test_function_saves_nothing_without_grad_mode():
    """Without grad mode the Function's path is not taken; with it, an input
    that takes no gradient gets none."""
    from repro_torch.kernels.autograd import needs_grad

    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    assert needs_grad(q, None)
    with torch.no_grad():
        assert not needs_grad(q)
    with torch.inference_mode():
        assert not needs_grad(q)
    k = torch.randn(1, 8, 2, 16)
    out = PlainGradient.apply(attention_reference, attention_reference, {"causal": True}, q, k, k)
    gq, = torch.autograd.grad(out.sum(), [q])
    assert gq.shape == q.shape


def test_ssd_plain_gradient_is_finite_where_the_references_is_nan():
    """At Mamba-2's decays (a = -exp(A_log) down to -16, dt up to ~3) the
    decays above a chunk's diagonal, exp(cum_t - cum_s) for s > t,
    overflow fp32.  The reference's ``where(tri, exp(dec), 0)`` then
    back-propagates 0 · inf = NaN; the port masks before the exp.  Its
    values stay the reference's, and its gradient is the step-by-step
    recurrence's (``ssd_decode_step`` in a loop, which takes no masked exp)
    within 1e-4."""
    rng = np.random.default_rng(5)
    B, S, H, P, N, L = 1, 32, 2, 4, 3, 16
    X = rng.normal(size=(B, S, H, P)).astype(np.float32)
    la = -rng.uniform(6.5, 10.0, size=(B, S, H)).astype(np.float32)  # 15 steps > 88
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(B, S, H, P)).astype(np.float32)

    def ref_loss(X, la, Bm, Cm):
        return (ref_ssd.ssd_reference(X, la, Bm, Cm, chunk=L)[0] * w).sum()

    want_y = ref_ssd.ssd_reference(*map(jnp.asarray, (X, la, Bm, Cm)), chunk=L)[0]
    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (X, la, Bm, Cm)))
    assert any(np.isnan(np.asarray(g)).any() for g in ref_grads)

    t = [torch.from_numpy(a).requires_grad_() for a in (X, la, Bm, Cm)]
    y, _ = ssd_reference(*t, chunk=L)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), t)
    r = [a.detach().clone().requires_grad_() for a in t]
    state, ys = torch.zeros(B, H, P, N), []
    for i in range(S):
        y_i, state = ssd_decode_step(state, r[0][:, i], r[1][:, i], r[2][:, i], r[3][:, i])
        ys.append(y_i)
    want = torch.autograd.grad((torch.stack(ys, 1) * torch.from_numpy(w)).sum(), r)
    for g, h in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-4)
