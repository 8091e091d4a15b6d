"""search: one `ActiveSearcher.search` of the call's queries (the mix's `batch`, `k`).

Its answers are checked against the plain reference's search of the index
built from the points live when the call was made (`reference/compare.py`);
each checked answer also gives its recall against the exact float64
neighbours and its mean Eq.-1 iterations (the run averages them), and the
window's last one the candidate stage's work.
"""

from __future__ import annotations

from perfbench.harness import roofline
from perfbench.reference import compare, exact
from perfbench.reference import index as ref_index
from perfbench.reference import search as ref_search


class Op:
    mutates = False
    answers = True

    def __init__(self, tr, k: int | None = None):
        self.tr = tr
        self.k = int(k if k is not None else tr.k)
        self.queries = tr.queries()
        self.last = None

    def prepare(self, steps: int) -> None:
        del steps

    def run(self, ctx, searcher, step: int):
        self.last = ctx.call("search", lambda: searcher.search(self.queries, self.k),
                             self.queries.shape[0])
        return searcher

    def take(self) -> dict:
        return {f: getattr(self.last, f).cpu() for f in ref_search.FIELDS}

    def at_step(self, step: int) -> dict:
        """What the call of step `step` asks besides the fields (nothing here)."""
        return {}

    def asked(self, got: dict):
        """(the queries an answer was given for, their key in a reference's memo)."""
        return self.queries, ("search", self.k)

    def forget(self) -> None:
        self.last = None

    def replay(self, table, step: int):
        return None

    def _want(self, ref, got: dict) -> dict:
        q, key = self.asked(got)
        return ref.memo(key, lambda: ref_search.search_blocked(ref.index, ref.cfg, q.to(
            ref.device), self.k))

    def check(self, ref, got: dict) -> dict:
        q = self.asked(got)[0].to(ref.device)
        want = {f: t.to(ref.device) for f, t in self._want(ref, got).items()}
        return compare.numbers({f: got[f].to(ref.device) for f in ref_search.FIELDS}, want, q,
                               ref.vectors, ref.labels, ref.alive)

    def control(self, ref, like: dict | None = None) -> dict:
        """The control's answer to the call `like` answered: the reference
        at ref's (TF32) precision."""
        q = self.asked(like or {})[0].to(ref.device)
        return {**(like or {}), **ref_search.search_blocked(ref.index, ref.cfg, q, self.k)}

    def summary(self, ref, got: dict, want_work: bool) -> dict:
        """recall@k against the exact neighbours among the live points, the
        mean Eq.-1 iterations and, when asked, the candidate stage's work."""
        q, key = self.asked(got)
        q = q.to(ref.device)
        truth = ref.memo(("truth",) + key, lambda: exact.knn_ids(q, ref.vectors[ref.ids],
                                                                  ref.ids, self.k))
        out = {"recall": exact.recall(got["ids"], truth),
               "iters_mean": float(got["iters"].double().mean())}
        if want_work:
            cfg = ref.cfg
            q_grid = ref_index.to_grid_coords(ref.index.proj, q, cfg.grid_size)
            st, en = ref_search.window_spans(ref.index, cfg, q_grid)
            out["candidate_work"] = roofline.candidate_work(
                st, en, ref.index.points.shape[0], cfg.row_cap, self.tr.d, self.k)
        return out
