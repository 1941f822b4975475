"""The parity rule of the parallel checks: a run across ranks held to one
process's run of the same updates.

Each parameter is first held to a relative L2 of :data:`REL_L2`. A
parameter past it passes only under the reference's Adam-step rule
(``__graft_entry__.py:496-551``, its tensor- and pipeline-parallel
dryruns), scaled by the update count U: every element within
``2.5 lr U`` of the one-process value (a sign flip of every update, with
slack), and under 5e-3 of all the model's elements more than ``0.2 lr``
apart. An element whose gradient is about 0 takes a step of about lr
either way, so summation order alone moves it that far: the span logits'
biases (their gradient is 0 but for rounding) do so in JAX's own
four-device run as in the port's (``tests/jax_mesh_drift.py``).
Gradients are held per parameter within ``1e-6 + 5e-3 max|g|``, the
reference's bound for its dryruns.

At ``precision: bf16`` a parallel step's gradients are held to one
process's bf16 step by the bf16 bound of a train step (``PERF.md`` §2,
:func:`hold_bf16_grads`): each within ``2^-5`` relative L2; or else,
where one process's bf16 gradient itself lies that far from its f32
gradient at the same weights (a gradient below bf16's rounding noise:
one that cancels in exact arithmetic, a bias summed over many rows), no
farther from the f32 gradient than ``2^-5`` of its norm or twice one
process's bf16 gradient. Where the parallel step rounds at other points
than one process's (the model axis's sharded recurrence keeps h and c in
bf16, as JAX's TP step's ``lax.scan``; the plain step's K3/K4 keep c in
f32, as JAX's Pallas kernels) the budget is doubled, ``2^-4``
(:data:`BF16_CROSS_REL_L2`): JAX's own TP step lies up to 5.612e-02 from
JAX's plain step at bf16 (``tests/bf16_axes_drift.py --tp-plain``, H=128
on the CPU), where the port's lies up to 4.302e-02.
"""

from __future__ import annotations

from typing import Dict

import torch

REL_L2 = 1e-4
BF16_GRAD_REL_L2 = 2.0 ** -5
BF16_CROSS_REL_L2 = 2.0 ** -4  # other rounding points than the reference
ADAM_STEPS = 2.5      # lr an update, every element
ADAM_NEAR = 0.2       # lr: the elements further apart than this ...
ADAM_SHARE = 5e-3     # ... are under this share of the model's
GRAD_ATOL, GRAD_RTOL = 1e-6, 5e-3


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    return float((got.double() - want).norm()
                 / max(float(want.norm()), 1e-12))


def hold_weights(what: str, got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor], lr: float,
                 updates: int) -> Dict[str, object]:
    """``got`` (a run across ranks) against ``want`` (one process), after
    ``updates`` updates at rate ``lr``, by the rule above; raises
    ``AssertionError`` naming the parameter where it fails. Returns the
    worst relative L2 and its parameter, that of the parameters within
    :data:`REL_L2`, the parameters that passed under the Adam-step rule,
    the largest difference in ``lr * updates`` units and the share of
    elements more than ``0.2 lr`` apart."""
    worst, worst_leaf, adam = 0.0, None, []
    within, within_leaf = 0.0, None
    total = far = 0
    largest = 0.0
    for k, v in want.items():
        d = (got[k].to(v.device).double() - v.double()).abs()
        total += d.numel()
        far += int((d > ADAM_NEAR * lr).sum())
        big = float(d.max()) if d.numel() else 0.0
        largest = max(largest, big)
        err = rel_l2(got[k].to(v.device), v)
        if err > worst:
            worst, worst_leaf = err, k
        if err <= REL_L2:
            if err > within:
                within, within_leaf = err, k
            continue
        if big > ADAM_STEPS * lr * updates:
            raise AssertionError(
                f'{what}: {k} relative L2 {err:.3e}, largest difference '
                f'{big:.3e} past {ADAM_STEPS} lr x {updates} updates')
        adam.append(k)
    share = far / max(total, 1)
    if adam and share >= ADAM_SHARE:
        raise AssertionError(f'{what}: {share:.3e} of the elements lie more '
                             f'than {ADAM_NEAR} lr apart ({adam} past the '
                             'relative L2)')
    return {'worst_rel_l2': worst, 'worst_leaf': worst_leaf,
            'worst_within_rel_l2': within, 'worst_within_leaf': within_leaf,
            'adam_leaves': adam,
            'max_lr_units': largest / (lr * updates),
            'share_near': share}


def hold_grads(what: str, got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> float:
    """Each gradient within ``1e-6 + 5e-3 max|want|`` of ``want``'s;
    returns the worst error as a share of its bound."""
    worst = 0.0
    for k, v in want.items():
        v = v.double()
        err = float((got[k].to(v.device).double() - v).abs().max())
        bound = GRAD_ATOL + GRAD_RTOL * float(v.abs().max())
        worst = max(worst, err / bound)
        if err > bound:
            raise AssertionError(f'{what}: gradient of {k} off by {err:.3e}, '
                                 f'bound {bound:.3e}')
    return worst


def hold_bf16_grads(what: str, got: Dict[str, torch.Tensor],
                    want: Dict[str, torch.Tensor],
                    want_f32: Dict[str, torch.Tensor],
                    budget: float = BF16_GRAD_REL_L2) -> Dict[str, object]:
    """``got`` (a run across ranks at bf16) against ``want`` (one
    process's bf16 gradients) by the bf16 rule above, ``want_f32`` one
    process's f32 gradients at the same weights, at ``budget``
    (BF16_GRAD_REL_L2, or BF16_CROSS_REL_L2 where the rounding points
    differ: the f32 clause's bound scaled with it); raises
    ``AssertionError`` naming every parameter where it fails. Returns the
    worst relative L2 and its parameter, the parameters held by the f32
    clause and, of those, the largest distance from the f32 gradient as a
    share of the clause's bound."""
    scale = budget / BF16_GRAD_REL_L2
    worst, worst_leaf, by_f32, of_bound = 0.0, None, [], 0.0
    failed = []
    for k, v in want.items():
        g = got[k].to(v.device).double()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f'{what}: gradient of {k} not finite')
        err = rel_l2(g, v)
        if err > worst:
            worst, worst_leaf = err, k
        if err <= budget:
            continue
        c = want_f32[k].to(v.device).double()
        bound = scale * max(BF16_GRAD_REL_L2 * float(c.norm()),
                            2 * float((v.double() - c).norm()))
        far = float((g - c).norm())
        if far > bound:
            failed.append(f'gradient of {k} relative L2 {err:.3e} from one '
                          f'process at bf16, {far:.3e} from its f32 '
                          f'gradient, bound {bound:.3e}')
            continue
        by_f32.append(k)
        of_bound = max(of_bound, far / max(bound, 1e-30))
    if failed:
        raise AssertionError(f'{what}: ' + '; '.join(failed))
    return {'worst_rel_l2': worst, 'worst_leaf': worst_leaf,
            'f32_clause_leaves': by_f32, 'f32_clause_of_bound': of_bound}
