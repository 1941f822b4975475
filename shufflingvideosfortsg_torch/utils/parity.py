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
"""

from __future__ import annotations

from typing import Dict

import torch

REL_L2 = 1e-4
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
