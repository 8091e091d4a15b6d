"""Deterministic synthetic LM data pipeline with per-host sharding + prefetch.

A copy of `repro/data/pipeline.py` (numpy in both packages, so a batch is
the reference's array for array); the port never imports the reference
package.

Production shape: every (step, host) pair maps to a disjoint, reproducible
slice of the token stream — restart-safe (resume at step k regenerates the
identical batch k) and elastic (re-sharding by host count changes only which
host holds which rows, never the global batch).  Tokens follow a Zipf-ish
bigram chain so the LM loss has learnable structure (tested).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


def _host_rows(cfg: DataConfig) -> tuple[int, int]:
    assert cfg.global_batch % cfg.n_hosts == 0
    rows = cfg.global_batch // cfg.n_hosts
    return cfg.host_id * rows, rows


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """The batch for `step`, host-local rows only.  Pure function of
    (seed, step, row) — the determinism contract the restart test checks.

    Token stream: a noisy affine Markov chain —
        x_{t+1} = (5 * x_t + 17 + eps_t) mod V,   eps ~ zipf-ish small noise
    — so the sequence HAS learnable transition structure: an LM learns the
    affine map, and a kNN-LM datastore memorizes exact continuations."""
    start, rows = _host_rows(cfg)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    probs = 1.0 / np.arange(1, 17) ** cfg.zipf_a
    probs /= probs.sum()
    x = rng.integers(0, cfg.vocab_size, size=cfg.global_batch)
    eps = rng.choice(16, size=(cfg.global_batch, cfg.seq_len + 1), p=probs)
    cols = [x]
    for t in range(cfg.seq_len):
        x = (5 * x + 17 + eps[:, t]) % cfg.vocab_size
        cols.append(x)
    stream = np.stack(cols, axis=1)
    local = stream[start : start + rows]
    return {
        "tokens": local[:, :-1].astype(np.int32),
        "labels": local[:, 1:].astype(np.int32),
    }


def add_frontend_inputs(batch: dict, cfg: ModelConfig, step: int, seed: int = 0) -> dict:
    """Attach stub modality inputs (assignment: frontends are stubs)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 77]))
    b, s = batch["tokens"].shape
    if cfg.frontend == "audio":
        batch["frame_embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return batch


class Prefetcher:
    """Background-thread prefetch of host batches (overlap input with step)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None, start_step: int = 0):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            if self.model_cfg is not None:
                batch = add_frontend_inputs(batch, self.model_cfg, step, self.cfg.seed)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
