"""The round's plain version: PyTorch's advanced indexing, as the engine ran
every round before the kernel (and runs it on the CPU).

``rnd`` is the engine's ``DeviceRound``: ``src_rows[d]`` is the rank that
sends to rank ``d``, ``src_ids[d]`` the chunk ids it sends, ``recv_ids[d]``
rank ``d``'s receive slots (distinct per rank).  Every payload is gathered
before any slot is written, so the result depends on no order of writes.
"""

from __future__ import annotations

import torch


def round_reference(buf: torch.Tensor, rows: torch.Tensor, rnd, transform=None) -> None:
    """One round on the rank-stacked ``(n, n_chunks, …)`` buffer, in place.

    ``rows`` is the ``(n, 1)`` column of ranks; ``transform`` (``None`` or a
    function of the payload) models the wire, e.g. int8 quantization, and
    sees the sending ranks' payloads in receiver order.
    """
    got = buf[rnd.src_rows, rnd.src_ids]  # (n, k, …): gather + permutation
    if transform is not None:
        got = transform(got)
    if rnd.reduce:
        got = buf[rows, rnd.recv_ids] + got
    buf[rows, rnd.recv_ids] = got
