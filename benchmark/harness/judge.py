"""The numbers that decide ``correct``, and their limits.

Training (the first steps of the run's own train state against the plain
reference from the same weights, queues and batches):

* ``loss_gap``: the largest relative gap of a step's summed loss;
  ``loss1_gap``: that of the first step's;
* ``grad_gap``: the worst leaf's gap between the norms of step 1's
  gradient (with its L2 decay, as the optimizer gets it; the program's
  worked out from Adam's first moment), against the larger of the
  reference leaf's norm and the median leaf's, over the leaves that the
  cell's limits file does not leave out by name (``left_out``);
  ``grad_median_gap``: the median leaf's;
* ``update_gap``: the same of the norm of each leaf's change after the
  steps.

Both norms are taken over each leaf's elements whose reference gradient
is at least a thousandth of the median leaf's root mean square
(``reference/model.py:STILL``): the others, such as the key projection's
bias under softmax, are nought but for round-off, and move under Adam
by round-off alone.

Evaluation (a sample of the window's evaluations, drawn from the seed):

* ``image_embed_gap`` / ``text_embed_gap``: the largest relative L2 gap of
  a sampled row's embedding from the reference towers';
* ``similarity_gap``: the largest gap of the program's similarity matrix
  from the reference's, computed from the program's embeddings;
* ``rerank_rows_gap``: the share of the rows of the re-ranking terms
  (the weighted Jaccard overlaps of the top-5 lists) that differ from
  the reference's, computed from the program's embeddings;
* ``rank_gap``: the largest gap, in points, of a CMC@k or mAP of the
  four columns (t2i, i2t and both re-ranked) from the reference's
  ranking of the program's own similarity and re-ranking terms.

Training adds ``queue_gap``: the largest relative L2 gap of a row of the
MoCo queues after the steps (the keys the steps wrote: the key towers'
forward) from the reference's."""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Optional

import numpy as np


def _gaps(program: dict, reference: dict) -> Dict[str, float]:
    """{leaf: |program's norm - reference's| / max(reference's, median
    leaf's)} over the leaves' moving elements."""
    norms = {}
    for n, still in reference["still"].items():
        moving = ~still.cpu()
        if bool(moving.any()):
            norms[n] = (float(program[n].cpu()[moving].norm()),
                        float(reference["of"][n].cpu()[moving].norm()))
    mid = median(r for _, r in norms.values())
    return {n: abs(p - r) / max(r, mid) for n, (p, r) in norms.items()}


def train_gaps(program: dict, reference: dict) -> Dict[str, dict]:
    """Each leaf's gradient and change gap (for the numbers and for a
    look at the worst leaves)."""
    return {what: _gaps(program[what], {"still": reference["still"],
                                        "of": reference[what]})
            for what in ("grad", "delta")}


def train_numbers(program: dict, reference: dict,
                  left_out: Optional[dict] = None) -> Dict[str, float]:
    """The training numbers; ``left_out``: ``{number: [leaf names]}`` whose
    gaps a number does not take (the cell's limits file names them, with
    the readings that led there)."""
    left_out = left_out or {}
    loss = max(abs(p - r) / max(abs(r), 1e-12)
               for p, r in zip(program["loss"], reference["loss"]))
    gaps = train_gaps(program, reference)
    first = program["loss"][0], reference["loss"][0]
    skip = set(left_out.get("grad_gap", ()))
    unknown = skip - set(gaps["grad"])
    if unknown:
        raise KeyError(f"grad_gap leaves out leaves the model does not "
                       f"have: {sorted(unknown)[:5]}")
    return {"loss_gap": loss,
            "loss1_gap": abs(first[0] - first[1]) / max(abs(first[1]), 1e-12),
            "grad_gap": max(g for n, g in gaps["grad"].items()
                            if n not in skip),
            "grad_median_gap": median(gaps["grad"].values()),
            "update_gap": max(gaps["delta"].values()),
            "queue_gap": embed_gap(program["queue"].cpu().numpy(),
                                   reference["queue"].cpu().numpy())}


def embed_gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(got - want, axis=1)
                  / np.maximum(np.linalg.norm(want, axis=1), 1e-12)).max())


GRID = ("t2i", "i2t", "re_t2i", "re_i2t")


def rank_gap(got: dict, want: dict) -> float:
    if not all(c in got for c in GRID):
        return math.inf
    return max([abs(got[c]["mAP"] - want[c]["mAP"]) for c in GRID]
               + [abs(a - b) for c in GRID
                  for a, b in zip(got[c]["cmc"], want[c]["cmc"])])


def hold(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` of every number the cell's limits
    name, and whether all are finite and within them.  A limit whose
    number the run did not produce fails; numbers the limits leave out
    are not compared."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return {"checks": checks, "correct": ok}
