"""Plain PyTorch version of K3: causal GQA softmax attention.

A port of ``repro.kernels.flash.ref.attention_reference``: the full
``(S, T)`` score matrix, computed in the inputs' dtype and softmaxed in
fp32, probabilities cast back to the inputs' dtype before the product with
V.  The CPU tests run it; on the card only ``chip_smoke.py`` and the card
tests run it, to hold the kernel against it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,   # (B, S, H, D)
    k: torch.Tensor,   # (B, T, K, D)
    v: torch.Tensor,   # (B, T, K, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    if causal:
        t = torch.arange(T, device=q.device)
        s = torch.arange(S, device=q.device)
        mask = t[None, :] <= s[:, None] + (T - S)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)
