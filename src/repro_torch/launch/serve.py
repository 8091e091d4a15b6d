"""Batched serving engine with the paper's technique as a first-class feature:
a kNN-LM head whose datastore is searched with ACTIVE SEARCH (core/knn_lm).

Port of `repro/launch/serve.py`.  Flow per batch of requests:
  prefill(prompts) -> caches + last hidden
  loop: decode_step -> hidden h_t
        active-search h_t in the datastore -> p_knn   (cost independent of N)
        logits' = log( lam * p_knn + (1-lam) * p_lm )
        sample/argmax -> next token

The datastore maps hidden states -> observed next tokens (Khandelwal-style);
`build_datastore_from_model` harvests it from the model's own forward pass
over a corpus.  `Engine` runs on one device where the reference's runs on a
mesh; `DynamicBatcher` queues datastore searches and online growth.

    python -m repro_torch.launch.serve --arch internlm2-1.8b --knn --knn-online
    python -m repro_torch.launch.serve --device cpu --knn ...   # no card

`--device` defaults to "cuda", with no fallback to the CPU.  The model is
the arch's SMOKE config with random weights (seed 0), as the reference's
CLI serves it; every one of the ten archs serves (`--arch`).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import ARCH_NAMES, get_smoke
from repro_torch.core import knn_lm
from repro_torch.core.active_search import SearchResult
from repro_torch.core.distributed import _pow2
from repro_torch.core.grid import GridIndex, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.model import DecoderLM, core_residual, mlp_residual

# sequences per batch of harvest_keys' layer-major forward (an MoE layer
# takes whole groups of about as many tokens)
HARVEST_BATCH = 16


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


class Engine:
    """Batched generation on one device (None = the card), where the
    reference's engine runs on a mesh.  The model and datastore are moved
    to that device; decode caches are updated in place step to step."""

    def __init__(self, cfg, model: DecoderLM, sc: ServeConfig,
                 datastore: GridIndex | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.sc = sc
        self.datastore = None if datastore is None else datastore.to(self.device)
        # --knn-online growth queue: opened on first use and kept across
        # batches, so chained inserts reuse the searcher's slack state (free
        # bucket slots) instead of re-deriving the layout every time
        self._ds_queue: DynamicBatcher | None = None
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, max_new: int | None = None):
        """prompts: (B, S) int tokens (an array or tensor).  Returns (tokens
        (B, new) int32 on the engine's device, hiddens) where hiddens is a
        LIST of new-1 per-step (B, d) tensors — hiddens[j] is the state that
        predicted tokens[:, j+1] (the prefill hidden that produced tokens[:,
        0] is not collected), the pairing extend_datastore relies on."""
        sc = self.sc
        max_new = max_new or sc.max_new_tokens
        toks_in = torch.as_tensor(prompts).to(device=self.device, dtype=torch.int32)
        b, s = toks_in.shape
        gen = torch.Generator(device=self.device).manual_seed(sc.seed)
        out_tokens, out_hidden = [], []
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, caches, hidden = self.model.prefill({"tokens": toks_in},
                                                        cache_len=s + max_new)
            self._sync()
            self.stats["prefill_s"] += time.perf_counter() - t0
            tok = self._pick(logits, hidden, gen)
            out_tokens.append(tok)
            t1 = time.perf_counter()
            for i in range(max_new - 1):
                logits, caches, hidden = self.model.decode_step(caches, tok, s + i)
                tok = self._pick(logits, hidden, gen)
                out_tokens.append(tok)
                out_hidden.append(hidden)
            self._sync()
        self.stats["decode_s"] += time.perf_counter() - t1
        self.stats["tokens"] += b * max_new
        return torch.stack(out_tokens, dim=1), out_hidden

    def datastore_queue(self) -> DynamicBatcher:
        """The engine's dynamic-batching queue over the kNN-LM datastore,
        opened on first use.  Its searcher owns the datastore's slack state
        across batches; `drain_datastore` republishes the grown snapshot."""
        if self.datastore is None or self.sc.knn is None:
            raise ValueError("datastore_queue needs a kNN-LM datastore")
        if self._ds_queue is None:
            searcher = api.ActiveSearcher.from_index(
                self.datastore, self.sc.knn.grid, plan=self.sc.knn.plan, device=self.device
            )
            self._ds_queue = DynamicBatcher(searcher, k=self.sc.knn.k)
        return self._ds_queue

    def queue_datastore_pairs(self, hiddens, tokens) -> int:
        """Queue ONLINE datastore growth from this engine's own decode
        stream: `hiddens` is the per-step hidden list from `generate`,
        `tokens` the (B, new) emitted tokens.  Pairs (h_t -> token_{t+1})
        enter the insert backlog (applied between search batches — see
        DynamicBatcher); returns the number of pairs queued."""
        if not hiddens:
            return 0
        keys = torch.cat([h.to(self.device, torch.float32) for h in hiddens])  # (B*(new-1), d)
        vals = torch.as_tensor(tokens).to(self.device, torch.int32)[:, 1:].T.reshape(-1)
        self.datastore_queue().offer_insert(keys, labels=vals)
        return int(keys.shape[0])

    def drain_datastore(self) -> int:
        """Apply the queued inserts (core/mutable.py deltas — no rebuild,
        no PCA re-fit) and publish the grown datastore so the next
        `generate` call searches it.  Returns the rows applied."""
        if self._ds_queue is None:
            return 0
        before = self._ds_queue.stats["inserts_applied"]
        self._ds_queue.drain()
        self.datastore = self._ds_queue.searcher.index
        return self._ds_queue.stats["inserts_applied"] - before

    def extend_datastore(self, hiddens, tokens) -> int:
        """Synchronous grow: queue the decode stream's pairs and drain at
        once.  Returns the number of pairs added."""
        if self.datastore is None or self.sc.knn is None:
            raise ValueError("extend_datastore needs a kNN-LM datastore")
        added = self.queue_datastore_pairs(hiddens, tokens)
        self.drain_datastore()
        return added

    def _pick(self, lm_logits, hidden, gen: torch.Generator) -> torch.Tensor:
        """The next token (B,) int32: log p_lm in the logits' dtype (or the
        kNN-LM interpolation), then argmax (ties to the first) or a draw
        from `gen`."""
        if self.datastore is not None and self.sc.knn is not None:
            logp = knn_lm.knn_lm_logits(
                self.datastore, self.sc.knn, hidden.to(torch.float32), lm_logits
            )
        else:
            logp = knn_lm.log_softmax(lm_logits)
        if self.sc.greedy:
            return torch.argmax(logp, dim=-1).to(torch.int32)
        probs = torch.softmax(logp.to(torch.float32) / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def harvest_keys(model: DecoderLM, corpus: torch.Tensor) -> torch.Tensor:
    """The final-normed hidden states (B, S - 1, d), float32, of the
    training forward over `corpus` (B, S) on the model's device, as the
    reference's one forward over the whole corpus gives them.

    The forward runs layer-major: the (B, S, d) activations of the whole
    corpus are held between layers, and each layer runs over them in
    batches.  A core (attention, Mamba, mLSTM, sLSTM) and a dense MLP take
    HARVEST_BATCH whole sequences at a time.  An MoE layer groups the B·S
    flattened tokens as the reference's one forward does (g = min(group
    size, B·S) tokens a group, the last padded with zero rows) and runs
    whole groups at a time; each group has its own capacity, so its drops
    are the reference's whatever the batch.  The last position's hidden,
    which predicts no token of the corpus, is dropped."""
    cfg = model.cfg
    b, s = corpus.shape
    d = cfg.d_model
    keys = torch.empty((b, s - 1, d), dtype=torch.float32, device=model.device)
    with torch.no_grad():
        x = model.embed_inputs({"tokens": corpus})
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        seqs = [(lo, min(b, lo + HARVEST_BATCH)) for lo in range(0, b, HARVEST_BATCH)]
        for layer in model.layers:
            is_moe = cfg.is_moe_layer(layer.p)
            for lo, hi in seqs:
                xb = core_residual(cfg, layer.p, layer, x[lo:hi], positions)
                x[lo:hi] = xb if is_moe else mlp_residual(cfg, layer.p, layer, xb)[0]
            if is_moe:
                _moe_layer_grouped(cfg, layer, x.view(b * s, d), HARVEST_BATCH * s)
        for lo, hi in seqs:
            keys[lo:hi] = L.rms_norm(x[lo:hi, :-1], model.final_norm, cfg.norm_eps)
    return keys


def _moe_layer_grouped(cfg, layer, x: torch.Tensor, batch_tokens: int) -> None:
    """x (T, d) += the MoE MLP of `layer` on it, in place: the reference's
    groups of the T tokens, run about `batch_tokens` tokens (whole groups)
    at a time."""
    t = x.shape[0]
    ng, g, cap = moe.group_shape(cfg, t)
    per = max(1, batch_tokens // g)
    for first in range(0, ng, per):
        lo, hi = first * g, min(t, (first + per) * g)
        h = L.rms_norm(x[lo:hi], layer.norm2, cfg.norm_eps)
        n = min(per, ng - first)
        y, _ = moe.moe_groups(layer.ffn, cfg, moe.group_tokens(h, n, g), cap)
        x[lo:hi] += y.reshape(n * g, -1)[:hi - lo]


def build_datastore_from_model(cfg, model: DecoderLM, corpus, knn_cfg) -> GridIndex:
    """Harvest (hidden_t -> token_{t+1}) pairs from the model's training
    forward over `corpus` (B, S) (`harvest_keys`) and build the
    active-search datastore on the model's device."""
    if cfg != model.cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, not {cfg.name}")
    corpus = torch.as_tensor(corpus).to(device=model.device, dtype=torch.int32)
    keys = harvest_keys(model, corpus)
    vals = corpus[:, 1:].reshape(-1)
    return knn_lm.build_datastore(keys.reshape(-1, cfg.d_model), vals, knn_cfg)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--knn", action="store_true", help="enable the kNN-LM head")
    ap.add_argument("--datastore-size", type=int, default=8192)
    ap.add_argument(
        "--knn-backend", default="hopper",
        help="registered active-search backend for the datastore "
             "(repro_torch.api.registered_backends(); 'hopper' = the Hopper "
             "kernels on the card, their plain versions on the CPU)",
    )
    ap.add_argument(
        "--knn-chunk", type=int, default=None,
        help="stream datastore searches through fixed-size query chunks "
             "(results are identical)",
    )
    ap.add_argument(
        "--knn-online", action="store_true",
        help="grow the kNN-LM datastore DURING serving: after each batch, "
             "delta-insert the decoded (hidden, next-token) pairs "
             "(core/mutable.py) so later batches retrieve from them — no "
             "rebuild between batches",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to serve on; 'cpu' runs the kernels' plain versions "
             "(no fallback: without a card the default raises)",
    )
    args = ap.parse_args(argv)
    if args.knn_online and not args.knn:
        raise SystemExit("--knn-online requires --knn")
    if args.knn:
        # fail on a bad backend name NOW, not after model init + datastore
        # build; count-only backends can't serve searches, and `sharded`
        # searches only a build_sharded handle, not this from_index one
        try:
            impl = api.get_backend(args.knn_backend)
        except ValueError as e:
            raise SystemExit(f"--knn-backend: {e}") from None
        searchable = [n for n in api.registered_backends()
                      if api.get_backend(n).search is not None and n != "sharded"]
        if args.knn_backend not in searchable:
            raise SystemExit(
                f"--knn-backend {args.knn_backend!r} cannot serve datastore "
                f"searches; pick one of {searchable}"
            )
        if args.knn_online and not impl.supports_mutation:
            mutable = [n for n in searchable if api.get_backend(n).supports_mutation]
            raise SystemExit(
                f"--knn-online: backend {args.knn_backend!r} does not "
                f"support mutation (BackendImpl.supports_mutation); pick "
                f"one of {mutable}"
            )

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    # ONE ExecutionPlan carries every execution knob from the CLI down
    # through KNNLMConfig -> ActiveSearcher
    plan = api.ExecutionPlan(backend=args.knn_backend, chunk_size=args.knn_chunk)
    knn_cfg = knn_lm.KNNLMConfig(plan=plan) if args.knn else None
    datastore = None
    if args.knn:
        corpus = rng.integers(
            0, cfg.vocab_size, size=(args.datastore_size // 64, 65), dtype=np.int32
        )
        datastore = build_datastore_from_model(cfg, model, corpus, knn_cfg)
        print(f"[serve] datastore: {datastore.n_points} keys "
              f"(search backend: {args.knn_backend}, device: {dev})")

    engine = Engine(cfg, model, ServeConfig(knn=knn_cfg), datastore, device=dev)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len),
                           dtype=np.int32)
    toks, hiddens = engine.generate(prompts, args.max_new)
    if args.knn_online:
        added = engine.queue_datastore_pairs(hiddens, toks)
        q = engine.datastore_queue()
        print(f"[serve] insert backlog: {q.stats['insert_backlog']} rows "
              f"(peak {q.stats['insert_backlog_peak']})")
        engine.drain_datastore()
        print(f"[serve] datastore grew online: +{added} pairs -> "
              f"{engine.datastore.n_points} keys (no rebuild)")
        prompts2 = rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len), dtype=np.int32
        )
        toks, _ = engine.generate(prompts2, args.max_new)
    s = engine.stats
    print(f"[serve] generated {tuple(toks.shape)} tokens")
    print(
        f"[serve] prefill {s['prefill_s']*1e3:.1f} ms, "
        f"decode {s['decode_s']*1e3:.1f} ms "
        f"({s['tokens']/max(s['decode_s'],1e-9):.1f} tok/s)"
    )


if __name__ == "__main__":
    main()
