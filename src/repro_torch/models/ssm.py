"""State-space blocks: Mamba-2 (SSD), the Mamba-2 half of ``repro.models.ssm``.

The same three-mode interface as the attention layers:

* ``train/prefill`` — chunkwise-parallel over the sequence (the SSD scan,
  K4 when ``cfg.use_pallas``); prefill also returns the recurrent state so
  decode can continue from it;
* ``decode`` — the O(1)-per-token recurrent update.

Two numeric traps of the reference are kept: ``jnp.split`` takes split
*indices* where ``torch.split`` takes sizes, and ``jax.nn.softplus`` has no
linear threshold where ``F.softplus`` switches to ``x`` above 20.  mLSTM and
sLSTM wait for the xLSTM family (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_reference

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
        "in_proj": normal_init((d, proj_out)),
        "conv_w": normal_init((s.conv_width, di + 2 * N), scale=0.5),
        "conv_b": zeros_init((di + 2 * N,)),
        "A_log": const_init(lambda: torch.log(torch.linspace(1.0, 16.0, H))),
        "D": ones_init((H,)),
        "dt_bias": const_init(dt_init),
        "norm_scale": ones_init((di,)),
        "out_proj": normal_init((di, d)),
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
    return g @ p["out_proj"].to(dt_), new_state


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device=None) -> Mamba2State:
    s, di, H, P, N = _mamba_dims(cfg)
    return Mamba2State(
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * N), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
    )
