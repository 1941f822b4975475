"""Optimizer, learning-rate schedule and train state.

Counterpart of ``shufflingvideosfortsg_tpu/train/state.py:40-115``, whose
optax chain mirrors the reference's torch optimizers (grounding/
train.py:367-387); here they are those torch optimizers:

- adam:  ``torch.optim.Adam(eps=1e-6, weight_decay=wd)``, the decay added
  to the gradient before the moments;
- adamw: ``torch.optim.AdamW(eps=1e-8)``, decoupled decay;
- sgd:   :class:`SGD`, ``torch.optim.SGD(momentum=params['momentum'])``
  written in tensor arithmetic, L2 decay.

With ``group_weight`` the decay skips Linear biases and LayerNorm
parameters (``group_weight_mask``). Gradients are clipped by global norm as
``optax.clip_by_global_norm`` does it, before the optimizer. The learning
rate is set before every update from :func:`lr_schedule_fn`, epoch-granular
(``epoch = step // steps_per_epoch``): 'ms' is MultiStepLR, 'l' the
reference's LambdaLR whose factor makes the rate lr * (lr - epoch * 1e-6).

On a card every optimizer reads its rate from a 0-d tensor on the card
that :meth:`TrainState.set_lr` fills, so an update reads no number from
the host and a CUDA graph can capture it; eager steps on the card take
the same path, so the two compute the same bits. Adam and AdamW are
built ``capturable``; ``torch.optim.SGD`` has no such form (its update
passes the rate as ``alpha``, read on the host), so SGD is the port's own
:class:`SGD`, on the CPU too. The CPU keeps Adam and AdamW as the
reference builds them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch import nn


def lr_schedule_fn(params: Dict[str, Any], steps_per_epoch: int
                   ) -> Callable[[int], float]:
    """step (updates done so far) -> learning rate of the next update."""
    base_lr = float(params['lr'])
    schd = str(params.get('lr_schd', 'ms')).lower()
    if schd in ('multistep', 'ms'):
        milestones = sorted(params.get('lr_step', [15]))
        gamma = float(params.get('lr_decay_rate', 0.1))

        def fn(step: int) -> float:
            epoch = step // steps_per_epoch
            return base_lr * gamma ** sum(epoch >= m for m in milestones)
        return fn
    if schd in ('lambda', 'l'):
        def fn(step: int) -> float:
            return base_lr * (base_lr - (step // steps_per_epoch) * 1e-6)
        return fn
    raise ValueError(f'unknown lr_schd: {schd}')


def decay_groups(model: nn.Module, weight_decay: float, grouped: bool
                 ) -> List[Dict[str, Any]]:
    """Parameter groups of the reference's ``group_weight``
    (helper_function.py:43-70): Linear weights decay, Linear biases and
    LayerNorm parameters do not, everything else (the recurrent weights and
    biases, the SCDM ``w``) does. Without ``grouped`` everything decays."""
    if not grouped:
        return [{'params': list(model.parameters()),
                 'weight_decay': weight_decay}]
    decay, no_decay = [], []
    for module in model.modules():
        own = list(module.parameters(recurse=False))
        if isinstance(module, nn.Linear):
            decay.append(module.weight)
            no_decay += [p for p in own if p is not module.weight]
        elif isinstance(module, nn.LayerNorm):
            no_decay += own
        else:
            decay += own
    return [{'params': decay, 'weight_decay': weight_decay},
            {'params': no_decay, 'weight_decay': 0.0}]


class SGD(torch.optim.Optimizer):
    """``torch.optim.SGD(lr, momentum, weight_decay)`` (no dampening, no
    Nesterov) as tensor arithmetic: g = grad + weight_decay * p; with
    momentum, buf = g at the first step and momentum * buf + g after it,
    and g = buf; then p -= lr * g. ``lr`` may be a 0-d tensor on the
    parameters' card, which the update reads there, so a CUDA graph
    captures a step (the momentum buffers exist from the first step on,
    which runs eagerly)."""

    def __init__(self, params, lr, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=float(momentum),
                                      weight_decay=float(weight_decay)))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            lr, mom, wd = group['lr'], group['momentum'], group['weight_decay']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad if wd == 0 else p.grad.add(p, alpha=wd)
                if mom != 0:
                    buf = self.state[p].get('momentum_buffer')
                    if buf is None:
                        buf = self.state[p]['momentum_buffer'] = g.clone()
                    else:
                        buf.mul_(mom).add_(g)
                    g = buf
                p.sub_(lr * g)


def make_optimizer(model: nn.Module, params: Dict[str, Any]
                   ) -> torch.optim.Optimizer:
    """The reference's optimizer over ``model``'s parameters. Its learning
    rate is set per update by :class:`TrainState`. Over parameters on a
    card the rate is a 0-d tensor on the card, and Adam and AdamW are
    ``capturable``."""
    wd = float(params.get('weight_decay', 0.0))
    groups = decay_groups(model, wd, bool(params.get('group_weight', False)))
    lr = float(params['lr'])
    name = str(params.get('optim', 'adam')).lower()
    opts = {'lr': lr}
    device = next(model.parameters()).device
    if device.type == 'cuda':
        opts = {'lr': torch.tensor(lr, dtype=torch.float32, device=device),
                'capturable': True}
    if name == 'adam':
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-6, **opts)
    if name == 'adamw':
        return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                 **opts)
    if name == 'sgd':
        return SGD(groups, lr=opts['lr'],
                   momentum=float(params.get('momentum', 0.8)))
    raise ValueError(f'unknown optimizer: {name}')


@torch.no_grad()
def clip_by_global_norm(parameters, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: gradients keep their values while
    their global norm is below ``max_norm`` and are scaled by max_norm/norm
    otherwise (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm,
    which is another result). Returns the norm before clipping."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class TrainState:
    """The model, its optimizer, the schedule and the update count
    (``TrainState`` of the JAX package; here the parameters live in the
    model and change in place). On a card a CUDA graph can capture
    :meth:`update`. :meth:`state_dict` and :meth:`load_state_dict` carry
    the count and the optimizer's state through a checkpoint's sidecar
    (``utils/saver.py``)."""

    def __init__(self, model: nn.Module, params: Dict[str, Any],
                 steps_per_epoch: int):
        self.model = model
        self.step = 0
        self.optimizer = make_optimizer(model, params)
        self.schedule = lr_schedule_fn(params, steps_per_epoch)
        self.clip = (float(params['grad_clip_max'])
                     if params.get('grad_clip') else None)

    def set_lr(self) -> None:
        """The schedule's rate for update ``step``, written into the
        optimizer (filled into its tensor on a card, never replacing it:
        a captured update reads that tensor)."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            if isinstance(group['lr'], torch.Tensor):
                group['lr'].fill_(lr)
            else:
                group['lr'] = lr

    def update(self) -> None:
        """Clip the gradients now in the parameters' ``.grad`` and take
        the optimizer's step at the rate set last; no host state changes,
        so on a card a CUDA graph can capture it."""
        if self.clip is not None:
            clip_by_global_norm(self.model.parameters(), self.clip)
        self.optimizer.step()

    def apply_gradients(self) -> None:
        """One update from the gradients now in the parameters' ``.grad``."""
        self.set_lr()
        self.update()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """The update count and the optimizer's ``state_dict`` (its
        tensors the live ones: copy them before the next update)."""
        return {'step': self.step, 'optimizer': self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict` in place: each optimizer state
        tensor that exists is overwritten with ``copy_``, one that does
        not yet (no update taken) is made on its parameter's device, and
        no parameter, state or rate tensor is replaced, so a CUDA graph
        captured over them stays valid. The rate follows the restored
        step (:meth:`set_lr`); the other hyperparameters stay the
        configuration's."""
        saved = sd['optimizer']
        groups = self.optimizer.param_groups
        sizes = [len(g['params']) for g in groups]
        want = [len(g['params']) for g in saved['param_groups']]
        if sizes != want:
            raise ValueError(f'optimizer state for groups of {want} '
                             f'parameters, this one has {sizes}')
        params = [p for g in groups for p in g['params']]
        ids = [i for g in saved['param_groups'] for i in g['params']]
        for p, i in zip(params, ids):
            live = self.optimizer.state[p]
            for key, value in saved['state'].get(i, {}).items():
                if key in live:
                    live[key].copy_(value)
                else:
                    live[key] = value.to(device=p.device, copy=True)
        self.step = int(sd['step'])
        self.set_lr()
