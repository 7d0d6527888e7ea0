"""The card's side of the kernel lint: what the lint cannot see statically.

Two checks, each on a real launch (so they need the card; ``chip_smoke.py``
path 13 and the ``cuda`` tests run them):

* :func:`geometry_mismatches` — each call site of a wrapper's launch
  model against what the built library's ``*_geometry`` export reports,
  computed by the same function its launcher launches with: the grid, the
  threads, the dynamic shared memory; and the kernel's static plus dynamic
  shared memory (``cudaFuncGetAttributes``) within the card's opt-in limit.
* :func:`probe_outputs` — the wrapper launched into outputs pre-filled
  with NaN, inside guard bands of a sentinel on both sides: every element
  must be written and every guard element untouched (the ground truth of
  ``coverage-gap`` and ``oob-write``).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .launch_model import LAUNCH_MODELS, CallSite, capture_call_sites

SENTINEL = 31.0  # exact in bf16 and fp32; no kernel of the port writes it by chance
GUARD = 1024  # elements on each side of an output (2 KiB in bf16: 16-byte aligned)


def _launch_module(fn: Callable):
    return importlib.import_module(LAUNCH_MODELS[f"{fn.__module__}.{fn.__qualname__}"])


def geometry_mismatches(
    fn: Callable, args: Sequence[Any], kwargs: Dict[str, Any], optin: int,
) -> Tuple[List[CallSite], List[dict], List[str]]:
    """(the model's call sites, what the library reports for each, every
    disagreement as a sentence); ``optin`` is the card's
    ``shared_memory_per_block_optin``."""
    sites = capture_call_sites(fn, *args, **kwargs)
    device = _launch_module(fn).device_geometry(*args, **kwargs)
    problems = []
    if len(device) != len(sites):
        problems.append(f"{len(sites)} modelled launches, {len(device)} on the card")
    for site, dev in zip(sites, device):
        grid = tuple(site.grid) + (1,) * (3 - len(site.grid))
        for what, model, card in (("grid", grid, tuple(dev["grid"])),
                                  ("threads", site.threads, dev["threads"]),
                                  ("dynamic smem", site.smem, dev["smem"])):
            if model != card:
                problems.append(f"{site.name}: {what} {model} in the model, {card} on the card")
        if dev["static_smem"] + dev["smem"] > optin:
            problems.append(f"{site.name}: {dev['static_smem']} B static + {dev['smem']} B "
                            f"dynamic shared memory over the card's {optin} B")
        if site.threads > dev["max_threads"]:
            problems.append(f"{site.name}: {site.threads} threads over the kernel's "
                            f"{dev['max_threads']}")
    return sites, device, problems


def materialize(torch, args, kwargs, device, generator):
    """Tensors on ``device`` in place of (meta) tensors: floating ones
    uniform in (-0.5, 0], so every kernel's output is finite (K4's log
    decays are negative); integer ones, the round kernel's index tables, a
    random permutation along their last dim, so a table of ``k`` entries a
    row addresses only slots below ``k`` and writes each of them once."""
    def real(a):
        if not isinstance(a, torch.Tensor):
            return a
        noise = torch.rand(tuple(a.shape), generator=generator, device=device)
        if a.dtype.is_floating_point:
            return -0.5 * noise.to(a.dtype)
        return noise.argsort(dim=-1).to(a.dtype)

    return tuple(real(a) for a in args), {k: real(v) for k, v in kwargs.items()}


def probe_outputs(torch, fn: Callable, args: Sequence[Any],
                  kwargs: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """Launch ``fn(*args, **kwargs)`` into NaN-filled outputs between guard
    bands; per output, its ``elements``, how many stayed ``unwritten`` (NaN)
    and how many guard elements it ``touched``."""
    specs = _launch_module(fn).out_buffers(*args, **kwargs)
    flats, views = {}, {}
    for name, (shape, dtype) in specs.items():
        n = 1
        for s in shape:
            n *= s
        flat = torch.full((n + 2 * GUARD,), SENTINEL, dtype=dtype, device=args[0].device)
        flat[GUARD:GUARD + n] = float("nan")
        flats[name], views[name] = flat, flat[GUARD:GUARD + n].view(shape)
    fn(*args, **kwargs, out=views["out"] if set(views) == {"out"} else views)
    torch.cuda.synchronize()
    result = {}
    for name, flat in flats.items():
        body = views[name]
        guard = torch.cat([flat[:GUARD], flat[GUARD + body.numel():]])
        result[name] = {"elements": body.numel(), "unwritten": int(torch.isnan(body).sum()),
                        "touched": int((guard != SENTINEL).sum())}
    return result
