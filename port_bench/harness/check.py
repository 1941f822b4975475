"""The numbers that decide ``correct``, and their comparison with the
limits a cell's ``limits/<workload>.json`` sets.

Training: each of the first steps' loss (and the first step's alone, a
forward that no backward has touched yet), the first gradient as Adam
took it and each parameter's change over those steps, program against
the plain reference from the same weights, batches and draws. The
gradient is not a smooth function of the weights at a ReLU whose input
is zero to rounding, so on a few seeds in a hundred the program and the
reference take its two sides, and the gradient, the later losses and the
change all read wide; the first step's loss is the number that the
lower precision fails and such a seed passes. A norm is
compared by the worst leaf: the gap between the program's norm of a leaf
and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone and
are left out of the change (the span heads' last biases, under a
softmax over time).

Answers (evaluation, serving): each checked answer's score, start[s] +
end[e], against the reference's best, and against the reference's score
at the program's own span, relative to the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median's


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Iterable[str]) -> List[Tuple[float, str]]:
    """Each leaf's gap of norms over max(its reference norm, the median
    reference norm), over ``keys``, the widest first."""
    keys = list(keys)
    pn = _norms({k: prog[k] for k in keys})
    rn = _norms({k: ref[k] for k in keys})
    median = float(np.median([rn[k] for k in keys]))
    return sorted(((abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30), k)
                   for k in keys), reverse=True)


def moving_leaves(raw_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(raw_grad)
    median = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= NEGLIGIBLE * median]


def train_numbers(prog_losses, ref_losses, prog_first, ref_first,
                  ref_raw, prog_change, ref_change, prog_parts,
                  ref_parts) -> Dict[str, float]:
    """``loss_gap``: each step's loss; ``first_loss_gap``: the first
    step's loss and each of its terms (``*_parts``), all over that loss."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    first = max([gaps[0]] + [abs(prog_parts[k] - ref_parts[k])
                             / abs(ref_losses[0]) for k in ref_parts])
    grad = leaf_gaps(prog_first, ref_first, ref_first)[0][0]
    change = leaf_gaps(prog_change, ref_change, moving_leaves(ref_raw))[0][0]
    return {'first_loss_gap': first, 'loss_gap': max(gaps),
            'first_grad_gap': grad, 'change_gap': change}


def answer_numbers(spans: np.ndarray, scores: np.ndarray,
                   start: torch.Tensor, end: torch.Tensor
                   ) -> Dict[str, float]:
    """Over the checked answers (program spans [n, 2] and scores [n],
    the reference's start and end probabilities [n, T]): ``score_gap``,
    the widest gap of the program's score from the reference's best, and
    ``span_gap``, of the program's score from the reference's score at
    the program's own span (infinite for a span with e < s or outside the
    clips), both relative to the reference's."""
    T = start.shape[1]
    start, end = start.double(), end.double()
    mat = start[:, :, None] + end[:, None, :]
    upper = torch.triu(torch.ones(T, T, dtype=torch.bool,
                                  device=start.device))
    best = mat.masked_fill(~upper, float('-inf')).flatten(1).max(1).values
    s = torch.as_tensor(np.asarray(spans), device=start.device).long()
    ok = (s[:, 0] >= 0) & (s[:, 1] < T) & (s[:, 0] <= s[:, 1])
    s = s.clamp(0, T - 1)
    at = (start.gather(1, s[:, :1])[:, 0] + end.gather(1, s[:, 1:])[:, 0])
    sc = torch.as_tensor(np.asarray(scores, np.float64), device=start.device)
    span = torch.where(ok, (sc - at).abs() / at,
                       torch.full_like(at, float('inf')))
    return {'score_gap': float(((sc - best).abs() / best).max()),
            'span_gap': float(span.max())}


def judge(numbers: Dict[str, float], limits: Dict
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is NaN, or that the limits name and the run did not give, fails."""
    checks, ok = {}, True
    for name, spec in limits['numbers'].items():
        value = numbers.get(name, float('nan'))
        checks[name] = {'value': value, 'limit': spec['limit']}
        if not value <= spec['limit']:
            ok = False
    return ok, checks
