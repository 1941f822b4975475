"""Multi-seed training: S independent seeds trained by one step.

Counterpart of ``shufflingvideosfortsg_tpu/train/multiseed.py``, under its
names: ``stack_states``, ``unstack_state``, ``n_seeds_of``,
``init_multiseed_states``, ``make_multiseed_train_step`` and
``make_multiseed_valid_step``.

The semantics are JAX's: the S seeds share the batch stream (one batch
feeds every seed's update) and differ in their initial weights, their
dropout draws and their on-device augmentation draws. JAX stacks the
seeds' parameter trees on a leading axis and vmaps the step; here a
multi-seed state holds S (model, :class:`~.state.TrainState`) pairs with
one optimizer configuration, and a multi-seed step runs the seeds'
single-seed steps one after another, seed i drawing from its own
``torch.Generator`` alone. JAX runs its LSTM kernels seed after seed as
well (``_seq_vmap``, ``ops/pallas/lstm_scan.py:41``); only its SCDM
forward takes the seed axis as a grid dimension, and computes what
per-seed calls do. So seed i of a multi-seed step launches the kernels
exactly as a single-seed step does, at the same shapes, and computes the
same bits as a single-seed step over its model and generator. The
kernels' launch plans (``ops/lstm_scan``, ``ops/scdm_fused``) are cached
by shape and device, never by a tensor's address, so the S seeds in one
CUDA graph (``cli._GraphedTick``) each launch on their own tensors.

Seed 0 is the single-seed run: its weights and its train generator come
from the run's ``seed``. Seed i >= 1 takes :func:`seed_of` (seed, i) for
both, where JAX folds i into its init key.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .state import TrainState

Batch = Dict[str, torch.Tensor]


def seed_of(base: int, i: int) -> int:
    """The seed of seed ``i`` of a multi-seed run whose ``seed`` is
    ``base``: ``base`` itself for seed 0, which is the single-seed run,
    and for i >= 1 the first 64-bit word of numpy's
    ``SeedSequence([base, i])``, which hashes the pair into a stream
    unrelated to ``base``'s and to every other seed's."""
    if i == 0:
        return int(base)
    word = np.random.SeedSequence([int(base), int(i)]).generate_state(
        1, np.uint64)[0]
    return int(word)


def _optimizer_config(state: TrainState):
    """What makes two seeds' optimizers one configuration: the optimizer's
    type, each parameter group's settings but its parameters and its rate
    (the schedule sets the rate), and the clip."""
    groups = [{k: v for k, v in g.items() if k not in ('params', 'lr')}
              for g in state.optimizer.param_groups]
    return type(state.optimizer), groups, state.clip


class MultiSeedState:
    """S train states, one a seed, each over its own model: JAX's stacked
    ``TrainState``. The seeds share the update count, so :meth:`set_lr`
    and :attr:`step` act on all of them; ``states[i]`` is seed i's."""

    def __init__(self, states: Sequence[TrainState]):
        self.states: List[TrainState] = list(states)

    @property
    def step(self) -> int:
        return self.states[0].step

    @step.setter
    def step(self, value: int) -> None:
        for state in self.states:
            state.step = value

    def set_lr(self) -> None:
        for state in self.states:
            state.set_lr()


def stack_states(states: Sequence[TrainState]) -> MultiSeedState:
    """The S train states as one multi-seed state. They must share one
    optimizer configuration, as JAX's ``tx``."""
    config = _optimizer_config(states[0])
    if not all(_optimizer_config(s) == config for s in states[1:]):
        raise ValueError('all seeds must share one optimizer')
    return MultiSeedState(states)


def unstack_state(stacked: MultiSeedState, i: int) -> TrainState:
    """Seed ``i``'s train state (its model is ``.model``)."""
    return stacked.states[i]


def n_seeds_of(stacked: MultiSeedState) -> int:
    return len(stacked.states)


def init_multiseed_states(init_fn: Callable[[int], torch.nn.Module],
                          seeds: Sequence[int], params: Dict[str, Any],
                          steps_per_epoch: int) -> MultiSeedState:
    """A multi-seed state from per-seed inits: ``init_fn(s)`` returns the
    model of each ``s`` of ``seeds`` (an init seed, or the driver's seed
    index); each gets a :class:`TrainState` of ``params``' optimizer and
    schedule."""
    return stack_states([TrainState(init_fn(int(s)), params, steps_per_epoch)
                         for s in seeds])


def _stack(outs: List[Batch]) -> Batch:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def make_multiseed_train_step(steps: Sequence[Callable], n_seeds: int):
    """Returns step(batch, *generators) -> metrics with a leading [S] axis:
    one update of every seed from one shared ``batch``, seed i by
    ``steps[i]`` (a train step of ``make_gmd_train_step`` or
    ``make_baseline_train_step`` over seed i's model and state) drawing
    from ``generators[i]``, one seed after another. Where every step has
    ``inner`` (GMD's), so has the multi-seed step, with ``state``, the
    seeds' :class:`MultiSeedState`, for the caller to set the rate and
    count the update on; a CUDA graph can capture it."""
    steps = list(steps)
    if len(steps) != n_seeds:
        raise ValueError(f'{len(steps)} steps for {n_seeds} seeds')

    def multi_step(batch: Batch, *generators: torch.Generator):
        return _stack([steps[i](batch, generators[i])
                       for i in range(n_seeds)])

    if all(hasattr(s, 'inner') for s in steps):
        def inner(batch: Batch, *generators: torch.Generator):
            return _stack([steps[i].inner(batch, generators[i])
                           for i in range(n_seeds)])
        multi_step.inner = inner
        multi_step.state = stack_states([s.state for s in steps])
    return multi_step


def make_multiseed_valid_step(valid_steps: Sequence[Callable]):
    """Returns valid(*args, generator=None) -> [seed i's
    ``valid_steps[i](*args)``, or with a ``generator``
    ``valid_steps[i](*args, generator)``]: a valid step over one batch, or
    the driver's valid pass, run for each seed. Every seed draws from
    ``generator`` what the first draws: its state is saved before seed 0
    and restored before each later seed, so afterwards it stands where one
    call leaves it. The counterpart of the one key JAX's multi-seed valid
    step gives every seed (GMD's pseudo videos)."""
    valid_steps = list(valid_steps)

    def multi_valid(*args, generator: Optional[torch.Generator] = None
                    ) -> List[Any]:
        if generator is None:
            return [step(*args) for step in valid_steps]
        start = generator.get_state()
        out = []
        for i, step in enumerate(valid_steps):
            if i:
                generator.set_state(start)
            out.append(step(*args, generator))
        return out

    return multi_valid
