"""The numbers that decide ``correct``, and the control's precision.

Plain torch only: nothing of the program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn
BLOCK_ROWS = 4096


@dataclass(frozen=True)
class Check:
    """One compared number and its limit: it holds while ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's relative error: max over rows of ‖got − want‖ / ‖want‖.

    ``want`` is float32; where it has one rank fewer than ``got`` it is the
    result every rank holds and is compared with each rank's rows."""
    if want.dim() == got.dim() - 1:
        return max(row_error(g, want) for g in got)
    g, w = _rows(got), _rows(want)
    if g.shape != w.shape:
        raise ValueError(f"shape {tuple(got.shape)} against the reference's {tuple(want.shape)}")
    worst = 0.0
    for a in range(0, g.shape[0], BLOCK_ROWS):
        gb, wb = g[a:a + BLOCK_ROWS].float(), w[a:a + BLOCK_ROWS].float()
        e = ((gb - wb).norm(dim=-1) / wb.norm(dim=-1).clamp_min(1e-30)).max().item()
        worst = max(worst, e if e == e else float("inf"))
    return worst


def max_difference(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest elementwise difference; 0 where the two agree exactly."""
    if want.dim() == got.dim() - 1:
        return max(max_difference(g, want) for g in got)
    g, w = _rows(got), _rows(want)
    if g.shape != w.shape:
        raise ValueError(f"shape {tuple(got.shape)} against the reference's {tuple(want.shape)}")
    worst = 0.0
    for a in range(0, g.shape[0], BLOCK_ROWS):
        d = (g[a:a + BLOCK_ROWS].float() - w[a:a + BLOCK_ROWS].float()).abs().max().item()
        worst = max(worst, d if d == d else float("inf"))
    return worst


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale for the tensor, back in
    float32: the control's precision, one step below bfloat16."""
    scale = t.abs().max().float().clamp_min(1e-30) / FP8_MAX
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    flat_in, flat_out = _rows(t), _rows(out)
    for a in range(0, flat_in.shape[0], BLOCK_ROWS):
        blk = flat_in[a:a + BLOCK_ROWS].float() / scale
        flat_out[a:a + BLOCK_ROWS] = blk.to(torch.float8_e4m3fn).float() * scale
    return out
