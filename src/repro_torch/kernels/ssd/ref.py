"""Plain PyTorch version of K4, the Mamba-2 SSD chunked scan.

A port of ``repro.kernels.ssd.ref``.  State space:
h_t = exp(la_t) · h_{t-1} + X_t ⊗ B_t,  y_t = C_t · h_t, with per-(step,
head) log-decay ``la`` and pre-weighted inputs ``X``.  The chunked
algorithm (chunk length L):

* intra-chunk: Y_diag[t] = Σ_{s≤t, same chunk} exp(cum_t − cum_s)(C_t·B_s) X_s
* chunk states: S_c = Σ_s exp(cum_last − cum_s) X_s ⊗ B_s
* inter-chunk recurrence: R_{c+1} = exp(Σ la_c)·R_c + S_c   (a Python loop)
* cross-chunk output: Y_off[t] = C_t · (exp(cum_t)·R_c)

B/C may be per-head (B,S,H,N) or shared across heads (B,S,N).  Returns
(Y (B,S,H,P), final_state (B,H,P,N)), both in ``X.dtype`` as the reference
returns them.  The CPU tests run it; on the card ``chip_smoke.py`` and the
card tests run it to hold the kernel against it, and the kernel's backward
pass differentiates it (``kernels/autograd.py``).  One deviation from the
reference: the intra-chunk decays are masked before the exp, not after, so
the gradient stays finite where the reference's is NaN; the values are the
same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import einsum as sharded_einsum


def _bc_expand(m: torch.Tensor) -> torch.Tensor:
    return m[:, :, None, :] if m.ndim == 3 else m  # (B,S,N) shared across heads


def ssd_reference(
    X: torch.Tensor,            # (B,S,H,P) pre-weighted inputs
    la: torch.Tensor,           # (B,S,H)   log decay per step
    Bm: torch.Tensor,           # (B,S,N) or (B,S,H,N)
    Cm: torch.Tensor,           # (B,S,N) or (B,S,H,N)
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = X.shape
    orig_S = S
    if S % chunk:
        pad = chunk - S % chunk
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        pad_spec = (0, 0) * (Bm.ndim - 2) + (0, pad)
        Bm = F.pad(Bm, pad_spec)
        Cm = F.pad(Cm, pad_spec)
        S = X.shape[1]
    L = chunk
    nc = S // L
    N = Bm.shape[-1]

    Xc = X.reshape(B, nc, L, H, P).float()
    lac = la.reshape(B, nc, L, H).float()
    Bc = _bc_expand(Bm).reshape(B, nc, L, -1, N).float()
    Cc = _bc_expand(Cm).reshape(B, nc, L, -1, N).float()
    Hb = Bc.shape[3]  # 1 (shared) or H

    cum = torch.cumsum(lac, dim=2)                             # (B,nc,L,H)
    total = cum[:, :, -1, :]                                   # (B,nc,H)

    # intra-chunk: decay[t,s] = exp(cum_t - cum_s) for s<=t.  Masked before
    # the exp: above the diagonal cum_t - cum_s > 0 overflows to inf at
    # Mamba-2's decays, and the reference's where(tri, exp(dec), 0) then
    # back-propagates 0 · inf = NaN; the values are the same bits
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=X.device))
    dec = torch.exp(torch.where(tri[None, None, :, :, None], dec, -torch.inf))
    scores = sharded_einsum("bclgn,bcmgn->bclmg", Cc, Bc)      # (B,nc,L,L,Hb)
    w = scores * dec                                           # broadcasts Hb == 1
    Y_diag = sharded_einsum("bclmh,bcmhp->bclhp", w, Xc)  # batch and heads may be split

    # chunk states: S_c = Σ_s exp(total - cum_s) X_s ⊗ B_s   → (B,nc,H,P,N)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)       # (B,nc,L,H)
    Xw = Xc * decay_to_end[..., None]
    if Hb == 1:
        states = sharded_einsum("bclhp,bcln->bchpn", Xw, Bc[:, :, :, 0])
    else:
        states = sharded_einsum("bclhp,bclhn->bchpn", Xw, Bc)

    # inter-chunk recurrence, emitting the state BEFORE each chunk
    carry = (
        torch.zeros((B, H, P, N), dtype=torch.float32, device=X.device)
        if initial_state is None
        else initial_state.float()
    )
    before = []
    for c in range(nc):
        before.append(carry)
        carry = carry * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    R = torch.stack(before, dim=1)                             # (B,nc,H,P,N)

    # cross-chunk output: C_t · (exp(cum_t) · R_c)
    if Hb == 1:
        Y_off = sharded_einsum("bcln,bchpn->bclhp", Cc[:, :, :, 0], R)
    else:
        Y_off = sharded_einsum("bclhn,bchpn->bclhp", Cc, R)
    Y_off = Y_off * torch.exp(cum)[..., None]

    Y = (Y_diag + Y_off).reshape(B, S, H, P)[:, :orig_S]
    return Y.to(X.dtype), carry.to(X.dtype)


def ssd_decode_step(
    state: torch.Tensor,        # (B,H,P,N)
    x: torch.Tensor,            # (B,H,P) pre-weighted input (dt·x)
    la: torch.Tensor,           # (B,H)   log decay
    Bm: torch.Tensor,           # (B,N) or (B,H,N)
    Cm: torch.Tensor,           # (B,N) or (B,H,N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step: O(1) in context length."""
    Bsz, H = x.shape[0], x.shape[1]
    if Bm.ndim == 2:
        Bm = Bm[:, None, :]
    if Cm.ndim == 2:
        Cm = Cm[:, None, :]
    Bm = Bm.expand(Bsz, H, Bm.shape[-1]).float()
    Cm = Cm.expand(Bsz, H, Cm.shape[-1]).float()
    st = state.float() * torch.exp(la.float())[:, :, None, None]
    st = st + x.float()[..., :, None] * Bm[..., None, :]
    y = sharded_einsum("bhpn,bhn->bhp", st, Cm)
    return y.to(x.dtype), st.to(state.dtype)
