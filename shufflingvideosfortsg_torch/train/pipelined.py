"""Pipeline-parallel GMD training: the deepened-QAVE depth-scaling path.

Counterpart of ``shufflingvideosfortsg_tpu/train/pipelined.py``
(``stack_encoder_tail`` ``:42-52``, ``unstack_encoder_tail`` ``:55-64``,
``to_pipelined_state`` ``:84-106``, ``to_sequential_state``
``:109-118``, ``is_pipelined_tree`` ``:121-123``,
``make_pipelined_forward`` ``:148-184``,
``make_gmd_pipelined_train_step`` ``:187-202``) and of JAX's
``cli._saveable_state`` (``:263-274``). With ``pipeline_stages`` k the
model is QAVE k + 1 blocks deep; blocks 1..k are the stages of the
``(data, pipe)`` mesh's pipe axis (``parallel/pipeline.py``).

Layouts. JAX keeps the tail stacked ([k, ...] leaves under
``video_encoder/tail``, sharded over the pipe axis); here the layout
functions work on state dicts (``video_encoder.tail.<name>`` [k, ...]
against ``video_encoder.blocks.{i}.<name>``), and a pipe rank's train
state (:class:`PipelinedState`) keeps its stage's block and that block's
optimizer state alone: the other stages' parameters are freed and their
optimizer state dropped; everything else is replicated. Checkpoints and
the valid pass gather the sequential ``block1..k`` layout (each stage's
tensors all-gathered over the pipe axis: the stacked tail, then
:func:`unstack_encoder_tail`), so the test drivers of both packages read
a pipelined run's checkpoints unchanged.

Gradients. The stages' are whole on their rank. Block 0 runs on each
pipe rank's rows, so its gradients are summed over the pipe axis
(``reduce_grads``). The rest is computed alike on every pipe rank and
reduced over the data column alone. The clip's global norm adds the
stages' squared norms over the pipe axis.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..parallel.mesh import DataMesh, MeshAxis
from ..parallel.pipeline import PIPE_AXIS, qave_pipelined, stack_stage_params
from .state import TrainState
from .steps import make_gmd_train_step

_BLOCKS = 'video_encoder.blocks.'
_TAIL = 'video_encoder.tail.'


def stack_encoder_tail(state_dict: Dict[str, torch.Tensor], nblocks: int
                       ) -> Dict[str, torch.Tensor]:
    """Sequential GMD state dict -> pipelined layout: blocks 1..nblocks-1
    replaced by one stacked ``video_encoder.tail.*`` entry a name
    ([nblocks - 1, ...])."""
    out = {k: v for k, v in state_dict.items()
           if not any(k.startswith(f'{_BLOCKS}{i}.')
                      for i in range(1, nblocks))}
    blocks = [{k[len(f'{_BLOCKS}{i}.'):]: v for k, v in state_dict.items()
               if k.startswith(f'{_BLOCKS}{i}.')} for i in range(1, nblocks)]
    out.update({_TAIL + k: v for k, v in stack_stage_params(blocks).items()})
    return out


def unstack_encoder_tail(state_dict: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Pipelined layout -> the sequential ``block1..k`` state dict."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(_TAIL)}
    for k, v in state_dict.items():
        if k.startswith(_TAIL):
            for i in range(v.shape[0]):
                out[f'{_BLOCKS}{i + 1}.{k[len(_TAIL):]}'] = v[i]
    return out


def is_pipelined_tree(state_dict) -> bool:
    return any(k.startswith(_TAIL) for k in state_dict)


class PipelinedState:
    """A pipe rank's share of ``state`` (a ``TrainState`` of GMD whose
    video encoder is QAVE, held whole and alike on every rank): stage s =
    ``axis.rank`` keeps block s + 1 and its optimizer state; the other
    stages' parameters are freed (``p.data`` empty) and their optimizer
    state dropped. Every method but :meth:`reduce_grads` is a collective
    over the pipe axis."""

    def __init__(self, state: TrainState, axis: MeshAxis):
        blocks = list(state.model.video_encoder.blocks)
        if len(blocks) - 1 != axis.size:
            raise ValueError(f'stacked params have {len(blocks) - 1} stages '
                             f'but the {axis.name!r} mesh axis is '
                             f'{axis.size}-way')
        # JAX's stack_stage_params checks: one treedef, one shape
        stack_stage_params([{k: torch.empty(v.shape, device='meta')
                             for k, v in b.state_dict().items()}
                            for b in blocks[1:]])
        self.state, self.axis = state, axis
        self.block0 = list(blocks[0].parameters())
        self.stages = [list(b.named_parameters()) for b in blocks[1:]]
        self.owned = [p for _, p in self.stages[axis.rank]]
        with torch.no_grad():
            for s, named in enumerate(self.stages):
                if s == axis.rank:
                    continue
                for _, p in named:
                    state.optimizer.state.pop(p, None)
                    p.data = p.data.new_empty(0)
                    p.grad = None

    def reduce_grads(self) -> None:
        """Block 0's gradients, of this rank's rows, summed over the pipe
        axis."""
        self.axis.sum_grads(self.block0)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """[n_stages, ...]: each stage's ``t`` (its block's tensor)."""
        return self.axis.all_gather(t.detach())

    @contextlib.contextmanager
    def gathered(self):
        """Every stage's parameters in the model, for the body (the valid
        pass); the other stages' freed after."""
        with torch.no_grad():
            full = [self._gather(p) for p in self.owned]
            for s, named in enumerate(self.stages):
                if s != self.axis.rank:
                    for (_, p), f in zip(named, full):
                        p.data = f[s].clone()
        try:
            yield
        finally:
            for s, named in enumerate(self.stages):
                if s != self.axis.rank:
                    for _, p in named:
                        p.data = p.data.new_empty(0)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The sequential ``state_dict``: the tail gathered stacked, then
        unstacked (JAX ``to_sequential_state`` of the weights)."""
        model = self.state.model
        own = dict(self.stages[self.axis.rank])
        sd = {k: v.detach() for k, v in model.state_dict().items()
              if not k.startswith(_BLOCKS) or k.split('.')[2] == '0'}
        sd.update({_TAIL + k: self._gather(p) for k, p in own.items()})
        full = unstack_encoder_tail(sd)
        return {k: full[k] for k in model.state_dict()}

    def state_dict(self) -> Dict[str, Any]:
        """:meth:`TrainState.state_dict` of the sequential model: the
        stages' optimizer state gathered over the pipe axis (each stage's
        tensors stacked, then taken apart), as one process's run holds
        it."""
        opt = self.state.optimizer
        sd = opt.state_dict()
        params = [p for g in opt.param_groups for p in g['params']]
        index = {id(p): i for i, p in enumerate(params)}
        state = dict(sd['state'])
        if self.owned[0] in opt.state:  # every rank has taken its updates
            for j, p in enumerate(self.owned):
                for key, v in opt.state[p].items():
                    full = self._gather(v)
                    for s, named in enumerate(self.stages):
                        state.setdefault(index[id(named[j][1])], {})[key] = \
                            full[s]
        return {'step': self.state.step,
                'optimizer': {'state': dict(sorted(state.items())),
                              'param_groups': sd['param_groups']}}


def to_pipelined_state(state: TrainState, mesh: DataMesh) -> TrainState:
    """``state`` (sequential, whole on every rank) as its pipe rank's
    share over ``mesh``'s pipe axis (:class:`PipelinedState`)."""
    if mesh.inner is None or mesh.inner.name != PIPE_AXIS:
        raise ValueError(f'a pipelined state needs a {PIPE_AXIS!r} mesh '
                         'axis (parallel/pipeline.create_pp_mesh)')
    state.pipelined = PipelinedState(state, mesh.inner)
    return state


def to_sequential_state(state: TrainState):
    """(weights, ``TrainState.state_dict``) of a pipelined state in the
    sequential layout (collectives over the pipe axis)."""
    return state.weights(), state.state_dict()


def make_pipelined_forward(model, axis: MeshAxis, n_micro: int,
                           train_dropout: bool = True):
    """A GMD pair forward with the QAVE tail pipelined over ``axis``:
    ``forward(batch, pseudo, generator)`` -> GMD's output dict,
    ``make_gmd_train_step``'s ``forward`` contract."""
    encoder = model.video_encoder
    nblocks = len(encoder.blocks)
    if nblocks - 1 != axis.size:
        raise ValueError(f'nblocks={nblocks} needs a {nblocks - 1}-way '
                         f'{axis.name!r} mesh axis (got {axis.size})')

    def forward(batch, pseudo, generator):
        word_feat, sent_embed = model.encode_query(batch['sent_feat'],
                                                   generator)
        both_video = torch.cat([batch['video_feat'], pseudo['video_feat']])
        both_words = torch.cat([word_feat, word_feat])
        if not train_dropout:
            encoder.eval()
        try:
            both_frame = qave_pipelined(encoder, both_video, both_words,
                                        axis, n_micro, generator)
        finally:
            encoder.train(model.training)
        return model.forward_from_frames(
            word_feat, sent_embed, both_frame, batch['video_mask'],
            pseudo['video_mask'], batch['temporal_labels'],
            batch['fore_masks'], batch['back_masks'],
            pseudo['temporal_labels'], pseudo['fore_masks'],
            pseudo['back_masks'], generator)

    return forward


def make_gmd_pipelined_train_step(model, state: TrainState,
                                  params: Dict[str, Any], mesh: DataMesh,
                                  n_micro: int, lg_frame2sec: bool = False,
                                  assembler=None,
                                  train_dropout: bool = True):
    """The 4-term GMD train step (``make_gmd_train_step``) with the QAVE
    tail pipelined over ``mesh.inner``, the pipe axis, in ``n_micro``
    microbatches. ``state`` becomes pipelined (:func:`to_pipelined_state`)
    before the first step."""
    axis = mesh.inner
    if axis is None or axis.name != PIPE_AXIS:
        raise ValueError(f'a pipelined step needs a {PIPE_AXIS!r} mesh axis '
                         '(parallel/pipeline.create_pp_mesh)')
    forward = make_pipelined_forward(model, axis, n_micro, train_dropout)

    def reduce_grads():
        state.pipelined.reduce_grads()

    return make_gmd_train_step(model, state, params, lg_frame2sec, assembler,
                               forward=forward, reduce_grads=reduce_grads)
