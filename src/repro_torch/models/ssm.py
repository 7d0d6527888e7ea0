"""State-space and recurrent blocks: Mamba-2 (SSD), xLSTM's mLSTM and sLSTM.

A port of ``repro.models.ssm``.  The same three-mode interface as the
attention layers:

* ``train/prefill`` — chunkwise-parallel over the sequence (the SSD scan,
  K4 when ``cfg.use_pallas``; the sLSTM, a loop over the steps); prefill
  also returns the recurrent state so decode can continue from it;
* ``decode`` — the O(1)-per-token recurrent update.

Numeric traps of the reference are kept: ``jnp.split`` takes split
*indices* where ``torch.split`` takes sizes; ``jax.nn.softplus`` has no
linear threshold where ``F.softplus`` switches to ``x`` above 20;
``jax.nn.gelu`` is the tanh form.  The mLSTM's numerator scan runs K4 under
``cfg.use_pallas`` and its denominator scan always the plain version, as
the reference calls them (``ssm.py:213-216`` there); the scans return their
final state in X's dtype, so after a bf16 prefill the mLSTM's state is bf16
although it started in fp32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_reference
from repro_torch.sharding import shard
from repro_torch.sharding.partition import flatten_last, unflattenable, whole_along

from .module import ParamSpec, const_init, normal_init, ones_init, zeros_init

# =============================================================== Mamba-2


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (B, conv_width-1, d_inner + 2*d_state)
    ssm: torch.Tensor    # (B, H, P, N)


def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    return s, di, H, s.head_dim, s.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0), no threshold."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp(x, min=0)


def init_mamba2(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s, di, H, P, N = _mamba_dims(cfg)
    d = cfg.d_model
    proj_out = 2 * di + 2 * N + H

    def dt_init():  # softplus^-1 of linspace(1e-3, 0.1)
        return torch.log(torch.exp(torch.linspace(1e-3, 0.1, H)) - 1.0)

    return {
        "in_proj": normal_init((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": normal_init((s.conv_width, di + 2 * N), (None, "ssm_inner"), scale=0.5),
        "conv_b": zeros_init((di + 2 * N,), ("ssm_inner",)),
        "A_log": const_init(lambda: torch.log(torch.linspace(1.0, 16.0, H)), ("ssm_heads",)),
        "D": ones_init((H,), ("ssm_heads",)),
        "dt_bias": const_init(dt_init, ("ssm_heads",)),
        "norm_scale": ones_init((di,), ("ssm_inner",)),
        "out_proj": normal_init((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv via shifted adds. x: (B,S,C); w: (cw,C).
    If ``state`` (B,cw-1,C) is given it provides left context; returns
    (y, new_state = last cw-1 inputs)."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    ext = torch.cat([state, x], dim=1)                 # (B, S+cw-1, C)
    y = b
    S = x.shape[1]
    for j in range(cw):
        y = y + ext[:, j:j + S, :] * w[j]
    # a copy, so the state does not keep the whole (B, S+cw-1, C) input alive
    new_state = ext[:, -(cw - 1):, :].clone() if cw > 1 else state
    return y, new_state


def apply_mamba2(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    state: Optional[Mamba2State] = None,
    mode: str = "train",
) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    s, di, H, P, N = _mamba_dims(cfg)
    dt_ = x.dtype
    B, S, _ = x.shape

    proj = x @ p["in_proj"].to(dt_)
    z, xin, Bc, Cc, dtr = torch.split(proj, [di, di, N, N, H], dim=-1)

    xBC = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state_in = state.conv if (state is not None and mode == "decode") else None
    if mode == "decode":
        assert state is not None and S == 1
    xBC, new_conv = _causal_conv(xBC, p["conv_w"].to(dt_), p["conv_b"].to(dt_), conv_state_in)
    xBC = F.silu(xBC)
    xin, Bc, Cc = torch.split(xBC, [di, N, N], dim=-1)

    xh = xin.reshape(B, S, H, P)
    xh = shard(xh, ("batch", "seq", "ssm_heads", None))
    dt = softplus(dtr.float() + p["dt_bias"])                             # (B,S,H)
    a = -torch.exp(p["A_log"].float())                                    # (H,)
    la = (dt * a).float()
    Xw = (xh.float() * dt[..., None]).to(dt_)

    new_state: Optional[Mamba2State] = None
    if mode == "decode":
        y, new_ssm = ssd_ops.ssd_decode_step(state.ssm, Xw[:, 0], la[:, 0], Bc[:, 0], Cc[:, 0])
        y = y[:, None]                                                    # (B,1,H,P)
        new_state = Mamba2State(new_conv, new_ssm)
    else:
        init = state.ssm if state is not None else None
        scan = ssd_ops.ssd if cfg.use_pallas else ssd_reference
        y, final = scan(Xw, la, Bc.contiguous(), Cc.contiguous(), chunk=s.chunk,
                        initial_state=init)
        if mode == "prefill":
            new_state = Mamba2State(new_conv, final)

    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)) * scale
    g = (y * F.silu(z)).float()
    var = g.square().mean(-1, keepdim=True)
    g = (g * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]).to(dt_)
    return shard(g @ p["out_proj"].to(dt_), ("batch", "seq", "act_embed")), new_state


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device=None) -> Mamba2State:
    s, di, H, P, N = _mamba_dims(cfg)
    return Mamba2State(
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * N), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
    )


# ================================================================ mLSTM


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, H, P, N) matrix memory
    n: torch.Tensor     # (B, H, 1, N) normalizer


def _mlstm_dims(cfg: ModelConfig):
    pf = cfg.xlstm.proj_factor
    di = int(pf * cfg.d_model)
    H = cfg.n_heads
    P = di // H
    N = cfg.d_model // H  # qk head dim = assigned head_dim
    return di, H, P, N


def init_mlstm(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di, H, P, N = _mlstm_dims(cfg)
    return {
        "up": normal_init((d, 2 * di), ("embed", "ssm_inner")),
        # block-diagonal per-head projections, as in the reference
        "wq": normal_init((H, P, N), ("ssm_heads", None, None), fan_in=P),
        "wk": normal_init((H, P, N), ("ssm_heads", None, None), fan_in=P),
        "wv": normal_init((H, P, P), ("ssm_heads", None, None), fan_in=P),
        "w_igate": normal_init((d, H), ("embed", "ssm_heads"), scale=0.02),
        "b_igate": zeros_init((H,), ("ssm_heads",)),
        "w_fgate": normal_init((d, H), ("embed", "ssm_heads"), scale=0.02),
        "b_fgate": const_init(lambda: torch.full((H,), 3.0), ("ssm_heads",)),  # open forget
        "norm_scale": ones_init((di,), ("ssm_inner",)),
        "down": normal_init((di, d), ("ssm_inner", "embed")),
    }


def apply_mlstm(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    state: Optional[MLSTMState] = None,
    mode: str = "train",
) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    di, H, P, N = _mlstm_dims(cfg)
    dt_ = x.dtype
    B, S, _ = x.shape
    up = x @ p["up"].to(dt_)
    u, z = up.chunk(2, dim=-1)
    # split by heads or, where they are too few for "model" (xLSTM-1.3B: 4
    # over 16), by each head's width, as the decode state's C: the per-head
    # products and both scans are independent per column of X
    uh = shard(unflattenable(u, H).reshape(B, S, H, P), ("batch", "seq", "ssm_heads", "ssm_inner"),
               fit=True)
    # per-head products, then / sqrt(N) in X's dtype, as the reference
    q = torch.einsum("bshp,hpn->bshn", uh, p["wq"].to(dt_)) / math.sqrt(N)
    k = torch.einsum("bshp,hpn->bshn", uh, p["wk"].to(dt_)) / math.sqrt(N)
    v = shard(torch.einsum("bshp,hpq->bshq", uh, p["wv"].to(dt_)),
              ("batch", "seq", "ssm_heads", "ssm_inner"), fit=True)
    i = torch.sigmoid((x @ p["w_igate"].to(dt_)).float() + p["b_igate"])
    la = F.logsigmoid((x @ p["w_fgate"].to(dt_)).float() + p["b_fgate"])

    Xw = (v.float() * i[..., None]).to(dt_)                           # i·v
    ones = i[..., None].to(dt_)                                       # i·1, (B,S,H,1)

    new_state: Optional[MLSTMState] = None
    if mode == "decode":
        assert state is not None and S == 1
        num, newC = ssd_ops.ssd_decode_step(state.C, Xw[:, 0], la[:, 0], k[:, 0], q[:, 0])
        den, newn = ssd_ops.ssd_decode_step(state.n, ones[:, 0], la[:, 0], k[:, 0], q[:, 0])
        num, den = num[:, None], den[:, None]
        new_state = MLSTMState(newC, newn)
    else:
        initC = state.C if state is not None else None
        initn = state.n if state is not None else None
        # einsum may hand back permuted strides; the kernel takes contiguous operands
        Xw, k, q = Xw.contiguous(), k.contiguous(), q.contiguous()
        scan = ssd_ops.ssd if cfg.use_pallas else ssd_reference
        num, finC = scan(Xw, la, k, q, chunk=cfg.xlstm.chunk, initial_state=initC)
        den, finn = ssd_reference(ones, la, k, q, chunk=cfg.xlstm.chunk, initial_state=initn)
        if mode == "prefill":
            new_state = MLSTMState(finC, finn)

    y = num.float() / torch.clamp(den.float().abs(), min=1.0)
    # whole along the sequence, which the scan's output may come split along
    # (its chunks, on torch 2.11), for ``down``'s view of the rows
    y = whole_along(flatten_last(y, 2).to(dt_), 1)
    # output norm, gated by silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]).to(dt_)
    y = y * F.silu(z)
    return shard(y @ p["down"].to(dt_), ("batch", "seq", "act_embed")), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype, device=None) -> MLSTMState:
    di, H, P, N = _mlstm_dims(cfg)
    return MLSTMState(
        C=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        n=torch.zeros((batch, H, 1, N), dtype=dtype, device=device),
    )


# ================================================================ sLSTM


class SLSTMState(NamedTuple):
    h: torch.Tensor    # (B, H, Dh)
    c: torch.Tensor    # (B, H, Dh)
    n: torch.Tensor    # (B, H, Dh)
    m: torch.Tensor    # (B, H, Dh)


def _slstm_dims(cfg: ModelConfig):
    H = cfg.n_heads
    Dh = cfg.d_model // H
    return H, Dh


def init_slstm(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H, Dh = _slstm_dims(cfg)
    f_mlp = max(int(4 * d / 3) // 2 * 2, 8)

    def bias():  # zeros, forget-gate bias (gate index 1) 2.0
        b = torch.zeros((4, H, Dh))
        b[1] = 2.0
        return b

    return {
        "w": normal_init((d, 4, H, Dh), ("embed", None, "ssm_heads", None)),
        "r": normal_init((H, Dh, 4, Dh), ("ssm_heads", None, None, None), fan_in=Dh),
        "b": const_init(bias, (None, "ssm_heads", None)),
        "norm_scale": ones_init((d,), ("embed",)),
        "ff1": normal_init((d, 2 * f_mlp), ("embed", "mlp")),
        "ff2": normal_init((f_mlp, d), ("mlp", "embed")),
    }


def _slstm_input(p, x: torch.Tensor) -> torch.Tensor:
    """The input half of every gate's pre-activation, fp32: x (…, d) →
    (…, 4, H, Dh).  One product for all steps of a prefill."""
    # the heads lead the product's columns, (d, H, 4, Dh): a split of the
    # heads is then a plain split of the columns on every torch release
    # (behind the gates it is a strided one, which torch 2.11 cannot place)
    w = p["w"].float().transpose(1, 2)
    y = unflattenable(x.float() @ flatten_last(w, 3), w.shape[1])
    y = y.reshape(*x.shape[:-1], *w.shape[1:]).transpose(-3, -2)
    # split by rows and heads, as the recurrence and its state are: the
    # gates' pre-activations are unbound along their own dimension
    axes = ("batch", "seq")[:x.ndim - 1] + (None, "ssm_heads", None)
    return shard(y, axes, fit=True)


def _slstm_cell(p, pre_x: torch.Tensor, st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One sLSTM timestep with exp gating + m-stabilizer, from the input
    half of the pre-activations ``pre_x`` (B, 4, H, Dh)."""
    f32 = torch.float32
    r = p["r"].to(f32)                                                 # (H, Dh, 4, Dh)
    H, Dh = r.shape[0], r.shape[1]
    # einsum("bhk,hkgj->bghj", h, r) as one batched product over heads
    rec = torch.bmm(st.h.to(f32).transpose(0, 1), r.reshape(H, Dh, 4 * Dh))  # (H, B, 4·Dh)
    pre = pre_x + rec.reshape(H, -1, 4, Dh).permute(1, 2, 0, 3)
    pre = pre + p["b"].to(f32)
    iraw, fraw, zraw, oraw = pre.unbind(1)
    m_prev = st.m.to(f32)
    m_new = torch.maximum(fraw + m_prev, iraw)
    i = torch.exp(iraw - m_new)
    f = torch.exp(fraw + m_prev - m_new)
    c = f * st.c.to(f32) + i * torch.tanh(zraw)
    n = f * st.n.to(f32) + i
    h = torch.sigmoid(oraw) * c / torch.clamp(n, min=1.0)
    new = SLSTMState(h.to(st.h.dtype), c.to(st.c.dtype), n.to(st.n.dtype), m_new.to(st.m.dtype))
    return h, new


def _slstm_step(p, x_t: torch.Tensor, st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One sLSTM timestep, as the reference's ``_slstm_step``. x_t: (B, d)."""
    return _slstm_cell(p, _slstm_input(p, x_t), st)


def apply_slstm(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    state: Optional[SLSTMState] = None,
    mode: str = "train",
) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """The reference's ``lax.scan`` over steps is a Python loop of
    :func:`_slstm_cell` here, with the input products of all steps taken
    at once before it: about 20 small launches a step on the card."""
    H, Dh = _slstm_dims(cfg)
    dt_ = x.dtype
    B, S, d = x.shape
    st = state if state is not None else init_slstm_state(cfg, B, torch.float32, x.device)

    new_state: Optional[SLSTMState] = None
    if mode == "decode":
        assert S == 1
        h, new_state = _slstm_step(p, x[:, 0], st)
        y = h.reshape(B, 1, d).to(dt_)
    else:
        # contiguous, as the host-bound loop below reads each step's gates
        pre_x = _slstm_input(p, x).contiguous()                        # (B, S, 4, H, Dh)
        hs = []
        for t in range(S):
            h, st = _slstm_cell(p, pre_x[:, t], st)
            hs.append(h)
        y = flatten_last(torch.stack(hs, dim=1), 2).to(dt_)
        new_state = st if mode == "prefill" else None

    # output norm + small GLU FFN (the sLSTM block carries its own MLP)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]).to(dt_)
    g, u = (y @ p["ff1"].to(dt_)).chunk(2, dim=-1)
    y = (F.gelu(g, approximate="tanh") * u) @ p["ff2"].to(dt_)
    return shard(y, ("batch", "seq", "act_embed")), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, dtype, device=None) -> SLSTMState:
    H, Dh = _slstm_dims(cfg)
    z = torch.zeros((batch, H, Dh), dtype=dtype, device=device)
    return SLSTMState(z, z, z, torch.full((batch, H, Dh), -30.0, dtype=dtype, device=device))
