"""Serving: a dynamic batching queue over one `ActiveSearcher`.

Port of the search side of `repro/launch/serve.py` (`ServeConfig` and
`DynamicBatcher`).  The reference's `Engine`, `build_datastore_from_model`
and `main` drive its LM stack, which this package does not have yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import Future

import torch

from repro_torch.core import knn_lm
from repro_torch.core.active_search import SearchResult
from repro_torch.core.distributed import _pow2


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    knn: knn_lm.KNNLMConfig | None = None
    seed: int = 0


class DynamicBatcher:
    """Request queue with dynamic batching over one `ActiveSearcher`.

    Requests (`submit`) are coalesced into batches padded up to the next
    power of two, as the reference pads them to reuse its compiled shapes;
    every lane is computed alone, so the padding changes no result.  Pad
    rows replicate the last real query and are sliced off before a
    request's future resolves: results are bit-identical to an unpadded
    call and pads never leak into the queue's truncation stats.

    `offer_insert` queues datastore growth instead of applying it inline;
    the backlog drains BETWEEN search batches (`step` alternates: one search
    batch, then any queued inserts), so a decode stream never waits on an
    insert mid-batch, and compaction pauses land on the batch boundary.
    `stats` tracks the backlog depth, pad overhead, per-request latency,
    and the searcher's own compaction accounting.
    """

    def __init__(self, searcher, k: int, max_batch: int = 64):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self.searcher = searcher
        self.k = k
        self.max_batch = max_batch
        self._requests: collections.deque = collections.deque()
        self._inserts: collections.deque = collections.deque()
        self._after_search = False  # drain inserts before the next batch
        self.stats = {
            "requests": 0, "request_rows": 0, "batches": 0, "batch_rows": 0,
            "pad_rows": 0, "truncated_rows": 0, "insert_rows_queued": 0,
            "insert_backlog": 0, "insert_backlog_peak": 0,
            "inserts_applied": 0, "latencies_s": [],
        }

    # ------------------------------------------------------------- enqueue --
    def submit(self, queries, op: str = "search") -> Future:
        """Queue a (Q, d) request (a tensor on any device, or an array); the
        future resolves to a `SearchResult` (op="search") or (Q,)
        predictions (op="classify") for exactly the submitted rows."""
        if op not in ("search", "classify"):
            raise ValueError(f"op must be 'search' or 'classify', got {op!r}")
        q = torch.as_tensor(queries)
        if q.dim() != 2 or q.shape[0] == 0:
            raise ValueError(f"queries must be (Q>0, d), got {tuple(q.shape)}")
        fut: Future = Future()
        self._requests.append((op, q, fut, time.perf_counter()))
        self.stats["requests"] += 1
        self.stats["request_rows"] += q.shape[0]
        return fut

    def offer_insert(self, points, labels=None, ids=None) -> int:
        """Queue datastore growth; applied between search batches (or by
        `drain`).  Returns the current insert backlog depth in rows."""
        self._inserts.append((points, labels, ids))
        self.stats["insert_rows_queued"] += int(points.shape[0])
        backlog = sum(int(p.shape[0]) for p, _, _ in self._inserts)
        self.stats["insert_backlog"] = backlog
        self.stats["insert_backlog_peak"] = max(
            self.stats["insert_backlog_peak"], backlog
        )
        return backlog

    # -------------------------------------------------------------- serve ---
    def step(self) -> bool:
        """Run ONE unit of work: the insert backlog if a search batch just
        ran (or nothing else is queued), else one dynamic search batch.
        Returns False when both queues are empty."""
        if self._inserts and (self._after_search or not self._requests):
            self._apply_inserts()
            self._after_search = False
            return True
        if not self._requests:
            return False
        self._run_batch()
        self._after_search = True
        return True

    def drain(self) -> None:
        """Serve until both the request and insert queues are empty."""
        while self.step():
            pass

    async def run_async(self, poll_s: float = 0.001) -> None:
        """Cooperative serving loop for an asyncio host: steps whenever work
        is queued, yields to the event loop when idle.  Cancel to stop."""
        import asyncio

        while True:
            if not self.step():
                await asyncio.sleep(poll_s)

    # ------------------------------------------------------------ internals -
    def _apply_inserts(self) -> None:
        rows = 0
        while self._inserts:
            pts, labels, ids = self._inserts.popleft()
            self.searcher = self.searcher.insert(pts, labels=labels, ids=ids)
            rows += int(pts.shape[0])
        self.stats["inserts_applied"] += rows
        self.stats["insert_backlog"] = 0

    def _run_batch(self) -> None:
        op = self._requests[0][0]
        batch, rows = [], 0
        while (self._requests and self._requests[0][0] == op
               and rows < self.max_batch):
            batch.append(self._requests.popleft())
            rows += batch[-1][1].shape[0]
        dev = self.searcher.device
        qs = torch.cat([b[1].to(device=dev, dtype=torch.float32) for b in batch])
        n = qs.shape[0]
        pad = _pow2(n) - n
        if pad:
            qs = torch.cat([qs, qs[-1:].expand(pad, -1)])
        if op == "search":
            out = self.searcher.search(qs, self.k)
            self.stats["truncated_rows"] += int(out.truncated[:n].sum())
        else:
            out = self.searcher.classify(qs, self.k)
        t_done = time.perf_counter()
        ofs = 0
        for _, q, fut, t0 in batch:
            m = q.shape[0]
            if op == "search":
                fut.set_result(SearchResult(*(a[ofs:ofs + m] for a in out)))
            else:
                fut.set_result(out[ofs:ofs + m])
            ofs += m
            self.stats["latencies_s"].append(t_done - t0)
        self.stats["batches"] += 1
        self.stats["batch_rows"] += n
        self.stats["pad_rows"] += pad
