"""replace: one `ActiveSearcher.insert` of `rows` fresh points, then one
`ActiveSearcher.delete` of `rows` live ids, so the live set keeps its size.

Every input of every step is drawn in set-up, before the window, and kept
in the host's pinned memory, from where the program's own calls take it:
the fresh points come from the data set's generator on streams of the run's
seed, in blocks of BLOCK steps, so any prefix of steps draws the same
points; the ids retired sit in slots of a table of the N live ids, and a
cycle of N // rows steps retires `rows` slots a step, drawn without
replacement from one permutation of the slots (a slot's new point takes the
next id, N + step * rows onwards).  `replay` makes the same changes to a
table of the reference's, from the same drawn inputs.
"""

from __future__ import annotations

import torch

from perfbench.harness.traffic import generator

BLOCK = 64


class Op:
    mutates = True
    answers = False

    def __init__(self, tr, rows: int):
        self.tr, self.rows = tr, int(rows)
        self.cycle = tr.n // self.rows
        if self.cycle < 1:
            raise ValueError(f"replace: {self.rows} rows a step from {tr.n} live points")
        self.steps = 0

    def _fresh(self, block: int):
        return self.tr.points(BLOCK * self.rows, self.tr.seed, "insert", block)

    def prepare(self, steps: int) -> None:
        """Draw the inputs of steps [0, steps) into pinned host memory."""
        tr, rows = self.tr, self.rows
        pin = tr.device.type == "cuda"
        blocks = [self._fresh(b) for b in range(-(-steps // BLOCK))]
        x = torch.cat([b[0] for b in blocks])[:steps * rows].cpu()
        self.x = (x.pin_memory() if pin else x).reshape(steps, rows, tr.d)
        self.labels = None
        if blocks[0][1] is not None:
            lab = torch.cat([b[1] for b in blocks])[:steps * rows].cpu()
            self.labels = (lab.pin_memory() if pin else lab).reshape(steps, rows)
        ids = tr.n + torch.arange(steps * rows, dtype=torch.int32).reshape(steps, rows)
        table = torch.arange(tr.n, dtype=torch.int32)
        dead, self.pos = torch.empty_like(ids), torch.empty_like(ids)
        for c in range(-(-steps // self.cycle)):
            perm = torch.randperm(tr.n, generator=generator(tr.device, tr.seed, "slots", c),
                                  device=tr.device).to("cpu", torch.int32)
            first, last = c * self.cycle, min(steps, (c + 1) * self.cycle)
            self.pos[first:last] = perm[:(last - first) * rows].reshape(-1, rows)
        for s in range(steps):
            pos = self.pos[s].long()
            dead[s] = table[pos]
            table[pos] = ids[s]
        self.ids = ids.pin_memory() if pin else ids
        self.dead = dead.pin_memory() if pin else dead
        self.steps = steps

    def run(self, ctx, searcher, step: int):
        x, ids, dead = self.x[step], self.ids[step], self.dead[step]
        labels = None if self.labels is None else self.labels[step]
        searcher = ctx.call("insert", lambda: searcher.insert(x, labels=labels, ids=ids),
                            self.rows)
        return ctx.call("delete", lambda: searcher.delete(dead), self.rows)

    def forget(self) -> None:
        pass

    def replay(self, table: torch.Tensor, step: int):
        """Apply step `step` to the reference's live table (slot -> id);
        returns the new points' (ids, vectors, labels) on the table's device."""
        dev = table.device
        ids = self.ids[step].to(dev)
        table[self.pos[step].to(dev, torch.int64)] = ids
        labels = None if self.labels is None else self.labels[step].to(dev)
        return ids, self.x[step].to(dev), labels
