"""Synthetic token data pipeline: host-sharded, deterministic, prefetching.

A copy of ``repro.data.pipeline`` (numpy only): each host generates its
disjoint shard of the global batch from a seeded Philox stream keyed by
``(seed << 32) ^ (step · n_hosts + host)``, so any host can regenerate any
step, and the batches are bit-equal to the reference's.  A background thread
keeps ``prefetch`` batches ahead of the consumer.  Batches are numpy;
:func:`to_device` puts one on a device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # straggler mitigation hook: a slow host can be assigned fewer grains
    grains_per_host: Optional[Dict[int, int]] = None


class SyntheticLMData:
    """Deterministic synthetic LM batches (zipf-ish token marginals so the
    loss curve is non-trivial)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        if data.global_batch % data.n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.per_host = data.global_batch // data.n_hosts

    def host_batch(self, step: int, host_id: Optional[int] = None) -> Dict[str, np.ndarray]:
        host = self.data.host_id if host_id is None else host_id
        # Philox keyed by (seed, step·N_hosts + host): any host regenerates
        # any step independently (checkpoint-restart / elastic re-shard)
        key = (self.data.seed << 32) ^ (step * max(self.data.n_hosts, 1) + host)
        gen = np.random.Generator(np.random.Philox(key=key))
        B, S = self.per_host, self.data.seq_len
        cfg = self.cfg
        # zipf marginals clipped to vocab
        toks = gen.zipf(1.3, size=(B, S)).astype(np.int64) % cfg.vocab
        out: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
        if cfg.vlm:
            out["tokens"] = out["tokens"][:, : S - cfg.vlm.n_img_tokens]
            out["img_embeds"] = gen.normal(
                size=(B, cfg.vlm.n_img_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.enc_dec:
            out["enc_frames"] = gen.normal(
                size=(B, cfg.enc_dec.enc_seq, cfg.d_model)
            ).astype(np.float32)
        return out

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """All hosts' shards concatenated (single-process testing/training)."""
        parts = [self.host_batch(step, h) for h in range(self.data.n_hosts)]
        return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}

    def iterate(self, start_step: int = 0, prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator from ``start_step`` (checkpoint resume).

        The worker thread stops when the iterator is closed or collected; it
        waits on a full queue with a timeout, so it sees that."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                item = (step, self.global_batch(step))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                _, batch = q.get()
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)


def to_device(batch: Dict[str, np.ndarray], device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``, values and dtypes unchanged."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
