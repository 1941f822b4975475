"""The GMD train, valid and test steps, and the QAVE baseline's train and
eval steps.

Counterpart of ``shufflingvideosfortsg_tpu/train/steps.py``:
``make_gmd_train_step`` (``:118-224``), ``make_gmd_valid_step``
(``:227-269``), ``make_gmd_test_step`` (``:301-351``),
``make_baseline_train_step`` (``:358-393``) and
``make_baseline_eval_step`` (``:396-437``); with ``topk`` > 1 the test
and eval steps also give each sentence's top-k NMS proposals
(``_topk_stats``, JAX ``:37``). Each takes an
``assembler`` (``data/device_bank.assemble``) that turns an attached
index-only batch into the model batch on the device. The test, eval and
GMD valid steps carry ``step.grouped``: G loader batches ``[G, B, ...]``
as one ``[G*B]`` model pass, with each batch's loss and mIoU its own
(``_flatten_group``/``_regroup``, JAX ``:277-298``). The GMD train step
carries ``step.inner``, its device work alone, which a CUDA graph can
capture (``cli._banked_train_chunks_factory``). With
``grad_accum_steps`` > 1 both train steps (and ``step.inner``) take an
update's gradient as the mean over that many microbatches, run one
after another (``_backward``, JAX ``_accumulate_grads``). The train
loss is the reference's (grounding/
train.py:140-165): grounding NLL + m1 * (intra-video BCE on raw and pseudo)
+ m2 * (inter-video span KL) + disc * (order-discrimination CE), plus
``loss_pseudo_ground_lambda`` * the grounding NLL of the pseudo stream
when that is set. Pseudo videos are made on the device
(``ops/augment_device.py``) unless ``on_device_aug`` is off, when the
batch carries the loader's host-made pseudo stream.

Random numbers come from the ``torch.Generator`` a step is given, in a
fixed order: the pseudo videos' insertion offsets, then the dropout masks.
No step synchronises with the host, reads a host tensor or branches on a
value on the device.

On the data axis (a train state's ``mesh`` with a process group, JAX's
step on the ``data`` mesh, ``train/steps.py:120-139, 213-214``) a step
runs on the rank's rows: the draws are the global batch's, each rank
keeping its rows; the intra BCE divides by the global mask sums; the
gradient is meaned over the ranks after the local backward (after every
microbatch) and before the clip and the optimizer
(``TrainState.update``); the metrics come back as the global batch's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from ..data.device_bank import BANK_KEYS
from ..parallel.mesh import uniform
from ..ops.augment_device import gt_translate_batch
from ..ops.losses import (bce_loss, masked_softmax, matching_kl_divergence,
                          span_ground_loss, span_ground_nll,
                          temporal_order_discrimination_loss)
from ..ops.span import iou_per_sample, span_decode, span_topk_nms
from .state import TrainState

# batch keys the test step reads, moved to the device per batch
STEP_KEYS = ('video_feat', 'sent_feat', 'video_mask', 'sent_mask',
             'framestps', 'timestps', 'nfeats', 'duration')
# the pseudo stream's keys, with a 'pseudo_' prefix in a host-made batch
PSEUDO_KEYS = ('video_feat', 'framestps', 'video_mask', 'temporal_labels',
               'fore_masks', 'back_masks')
TRAIN_KEYS = STEP_KEYS + ('temporal_labels', 'fore_masks', 'back_masks')
HOST_PAIR_KEYS = TRAIN_KEYS + tuple('pseudo_' + k for k in PSEUDO_KEYS)

Batch = Dict[str, torch.Tensor]


def to_device(batch: Dict[str, Any], device: torch.device,
              keys: Sequence[str] = STEP_KEYS) -> Batch:
    """``keys`` of a host batch as tensors on ``device``; f16 features (a
    raw f16 pack's gather) cross as f16 and widen to f32 there."""
    out = {}
    for k in keys:
        t = torch.from_numpy(np.asarray(batch[k])).to(device)
        out[k] = t.float() if t.dtype == torch.float16 else t
    return out


def _identity(batch: Batch) -> Batch:
    return batch


def _decode(start_prob, end_prob, batch: Batch, lg_frame2sec: bool):
    """(pred_time [B, 2] f32, score [B], IoU [B]) of the decoded spans."""
    pred, score = span_decode(start_prob, end_prob)
    pred_f = pred.float()
    if lg_frame2sec:
        pred_f = pred_f / batch['nfeats'][:, None].float() \
            * batch['duration'][:, None].float()
    return pred_f, score, iou_per_sample(pred_f, batch['timestps'])


def _stats(start_prob, end_prob, batch: Batch, lg_frame2sec: bool):
    """(pred_time [B, 2] f32, score [B], mean IoU) of the decoded spans."""
    pred_f, score, iou = _decode(start_prob, end_prob, batch, lg_frame2sec)
    return pred_f, score, iou.mean()


def _topk_stats(start_prob, end_prob, batch: Batch, lg_frame2sec: bool,
                k: int, nms_iou: float):
    """(proposals [B, k, 2] f32 in prediction time units, scores [B, k]):
    the top-k spans after NMS; an exhausted pool repeats its last span
    with score -inf."""
    spans, scores = span_topk_nms(start_prob, end_prob, k,
                                  iou_threshold=nms_iou)
    spans_f = spans.float()
    if lg_frame2sec:
        scale = batch['duration'] / batch['nfeats'].float()
        spans_f = spans_f * scale[:, None, None].float()
    return spans_f, scores


def _flatten_group(gbatch: Batch):
    """[G, B, ...] batch -> ([G*B, ...] batch, G, B); the bank's resident
    tensors pass through."""
    G, B = gbatch['nfeats'].shape[:2]
    flat = {k: v if k in BANK_KEYS else v.reshape((G * B,) + v.shape[2:])
            for k, v in gbatch.items()}
    return flat, G, B


def _regroup(per_sample: Batch, G: int, B: int) -> Batch:
    """Per-sample [G*B, ...] outputs -> each loader batch's loss and mIoU
    (the means over its B rows, as the ungrouped step gives them) and
    [G, B, ...] outputs."""
    res = {'loss': per_sample.pop('nll').reshape(G, B).mean(1),
           'miou': per_sample.pop('iou').reshape(G, B).mean(1)}
    for k, v in per_sample.items():
        res[k] = v.reshape((G, B) + v.shape[1:])
    return res


def _device_pseudo(batch: Batch, generator: torch.Generator,
                   groups: int = 1) -> Batch:
    """The pseudo stream made on the device from one uniform draw a row,
    drawn as ``groups`` calls in row order: the draws of as many batches
    of ``rows / groups`` made one after another (in a data-parallel step,
    the global batch's draws, of which the rank keeps its rows:
    ``parallel/mesh.uniform``)."""
    video = batch['video_feat']
    draws = [uniform((video.shape[0] // groups,), generator, video.device)
             for _ in range(groups)]
    u = draws[0] if groups == 1 else torch.cat(draws)
    feat, framestps, masks = gt_translate_batch(u, video, batch['framestps'],
                                                batch['nfeats'])
    return {'video_feat': feat, 'framestps': framestps, **masks}


def _pair_forward(model, batch: Batch, pseudo: Batch, generator):
    return model(batch['sent_feat'], batch['sent_mask'],
                 batch['video_feat'], batch['video_mask'],
                 pseudo['video_feat'], pseudo['video_mask'],
                 batch['temporal_labels'], batch['fore_masks'],
                 batch['back_masks'], pseudo['temporal_labels'],
                 pseudo['fore_masks'], pseudo['back_masks'],
                 generator=generator)


def _match_losses(out, batch: Batch, pseudo: Batch, m1: float, m2: float,
                  mesh=None):
    """(grounding NLL, m1 * intra BCE, m2 * inter KL), batch means. On a
    ``mesh`` with a process group the intra BCE divides by the global
    batch's mask sums (one all-reduce) and is scaled by the world size,
    so the ranks' mean is the global batch's loss, as JAX's mesh step
    computes it; the other terms are batch means already."""
    loss_g = span_ground_loss(out['start_prob'], out['end_prob'],
                              batch['framestps'])
    masks = (batch['video_mask'], pseudo['video_mask'])
    sums, scale = (None, None), 1
    if mesh is not None and mesh.distributed:
        sums = mesh.all_sum_(torch.stack([m.float().sum()
                                          for m in masks])).unbind()
        scale = mesh.world
    bce = (bce_loss(out['ori_match_prob'], batch['temporal_labels'],
                    masks[0], sums[0])
           + bce_loss(out['pseudo_match_prob'], pseudo['temporal_labels'],
                      masks[1], sums[1]))
    loss_intra = m1 * (bce if scale == 1 else scale * bce)
    ori_sm = masked_softmax(out['ori_match_prob'], batch['temporal_labels'])
    pse_sm = masked_softmax(out['pseudo_match_prob'],
                            pseudo['temporal_labels'])
    loss_inter = m2 * matching_kl_divergence(
        ori_sm, pse_sm, batch['framestps'], pseudo['framestps'])
    return loss_g, loss_intra, loss_inter


# the batch keys the GMD loss reads: the only ones split into microbatches
# (nfeats, duration, timestps feed the full batch's statistics)
_GMD_LOSS_KEYS = ('sent_feat', 'sent_mask', 'video_feat', 'video_mask',
                  'temporal_labels', 'fore_masks', 'back_masks', 'framestps')
_BASELINE_LOSS_KEYS = ('video_feat', 'sent_feat', 'video_mask', 'sent_mask',
                       'framestps')


def _backward(loss_fn, params, batch: Batch, pseudo: Batch, generator,
              accum: int, keys: Sequence[str]) -> Batch:
    """The gradient of ``loss_fn(batch, pseudo, generator) -> (loss, aux)``
    into the parameters' ``.grad`` (zeroed first), and its ``aux``.

    With ``accum`` > 1 (JAX ``_accumulate_grads``, ``train/steps.py:57``)
    ``keys`` of the batch and the whole pseudo stream are split into
    ``accum`` microbatches of consecutive rows, run one after another
    (activation memory is one microbatch's), each drawing its own dropout
    masks from ``generator``; their gradients are summed and divided by
    ``accum``. Scalars of ``aux`` are the microbatches' mean, per-sample
    outputs are concatenated back to the full batch."""
    params = list(params)
    for p in params:
        p.grad = None
    if accum == 1:
        loss, aux = loss_fn(batch, pseudo, generator)
        loss.backward()
        return aux
    b = next(iter(pseudo.values())).shape[0] if pseudo else \
        batch[keys[0]].shape[0]
    if b % accum:
        raise ValueError(f'grad_accum_steps={accum} must divide the batch '
                         f'size ({b})')
    rows = b // accum
    auxs = []
    for i in range(accum):
        def part(x):
            return x[i * rows:(i + 1) * rows]
        loss, aux = loss_fn({k: part(batch[k]) for k in keys if k in batch},
                            {k: part(v) for k, v in pseudo.items()},
                            generator)
        loss.backward()
        auxs.append({k: v.detach() for k, v in aux.items()})
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum)
    return {k: (torch.stack([a[k] for a in auxs]).mean() if v.dim() == 0
                else torch.cat([a[k] for a in auxs]))
            for k, v in auxs[0].items()}


def _global_means(metrics: Batch, mesh) -> Batch:
    """A step's metrics, meaned over a mesh's ranks where it has a process
    group (the global batch's values on every rank)."""
    return metrics if mesh is None else mesh.mean_metrics(metrics)


def make_gmd_train_step(model, state: TrainState, params: Dict[str, Any],
                        lg_frame2sec: bool = False, assembler=None,
                        forward=None, reduce_grads=None
                        ) -> Callable[[Batch, torch.Generator], Batch]:
    """Returns step(batch, generator) -> metrics: one optimizer update of
    ``state`` from one batch of raw videos (and, without
    ``on_device_aug``, their host-made pseudo videos). The metrics are the
    loss, its terms and the mean IoU of the raw stream's decoded spans,
    as 0-d tensors on the batch's device. ``step.loss_fn(batch, pseudo,
    generator) -> (loss, aux)`` is the loss alone. ``step.inner(batch,
    generator)`` is the step without its host bookkeeping: the caller
    sets ``step.state``'s rate (``set_lr``) and counts the update.

    ``forward(batch, pseudo, generator)`` -> GMD's output dict replaces
    the model's pair forward (JAX's ``forward`` seam, ``:118-126``): the
    tensor- and pipeline-parallel encoders plug in there and keep this
    loss. ``reduce_grads()``, where given, runs after the backward and
    before the update: their reduction of the gradients over the mesh's
    inner axis."""
    m1 = float(params['loss_m1_lambda'])
    m2 = float(params['loss_m2_lambda'])
    md = float(params['loss_disc_lambda'])
    mpg = float(params.get('loss_pseudo_ground_lambda', 0) or 0)
    on_device_aug = bool(params.get('on_device_aug', True))
    accum = int(params.get('grad_accum_steps', 1) or 1)
    assemble = assembler or _identity

    def loss_fn(batch: Batch, pseudo: Batch, generator):
        out = (_pair_forward(model, batch, pseudo, generator)
               if forward is None else forward(batch, pseudo, generator))
        loss_g, loss_intra, loss_inter = _match_losses(out, batch, pseudo,
                                                       m1, m2, state.mesh)
        loss_disc = temporal_order_discrimination_loss(
            out['ori_disc_prob'], out['pseudo_disc_prob'])
        loss = loss_g + loss_intra + loss_inter + md * loss_disc
        if mpg > 0:
            # beyond the reference: grounding NLL of the pseudo stream at
            # its translated labels, through the shared span predictor
            loss = loss + mpg * span_ground_loss(
                out['pseudo_start_prob'], out['pseudo_end_prob'],
                pseudo['framestps'])
        aux = {'loss': loss, 'loss_g': loss_g, 'loss_intra': loss_intra,
               'loss_inter': loss_inter, 'loss_d': loss_disc,
               'start_prob': out['start_prob'], 'end_prob': out['end_prob']}
        return loss, aux

    def inner(batch: Batch, generator: torch.Generator) -> Batch:
        model.train()
        batch = assemble(batch)
        with state.forward_context():
            if on_device_aug:
                pseudo = _device_pseudo(batch, generator)
            else:
                pseudo = {k: batch['pseudo_' + k] for k in PSEUDO_KEYS}
            aux = _backward(loss_fn, model.parameters(), batch, pseudo,
                            generator, accum, _GMD_LOSS_KEYS)
        if reduce_grads is not None:
            reduce_grads()
        state.update()
        metrics = {k: v.detach() for k, v in aux.items()}
        *_, metrics['miou'] = _stats(metrics.pop('start_prob'),
                                     metrics.pop('end_prob'), batch,
                                     lg_frame2sec)
        return _global_means(metrics, state.mesh)

    def train_step(batch: Batch, generator: torch.Generator) -> Batch:
        state.set_lr()
        metrics = inner(batch, generator)
        state.step += 1
        return metrics

    train_step.loss_fn = loss_fn
    train_step.inner = inner
    train_step.state = state
    return train_step


def make_gmd_valid_step(model, params: Dict[str, Any],
                        lg_frame2sec: bool = False, assembler=None,
                        mesh=None
                        ) -> Callable[[Batch, torch.Generator], Batch]:
    """The reference's valid(): the pair forward without dropout on device-
    made pseudo videos, the losses less the discriminator term, and the
    decoded spans for the submit file (train.py:209-318).
    ``step.grouped(gbatch, generator)`` takes G batches [G, B, ...]: each
    batch's pseudo draws as the step batch by batch makes them (G draws of
    B in batch order), one [G*B] pair forward, each batch's losses over
    its own B rows, loss terms and miou [G] and the outputs [G, B, ...];
    the counterpart of JAX's keyed valid tick (``cli.py:513-515``). On a
    ``mesh`` with a process group the pseudo draws are the global batch's
    and the intra BCE the global batch's share (:func:`_match_losses`);
    the caller means the per-batch metrics over the ranks."""
    m1 = float(params['loss_m1_lambda'])
    m2 = float(params['loss_m2_lambda'])
    assemble = assembler or _identity
    rows_of = mesh.rows if mesh is not None else contextlib.nullcontext

    def losses(out, batch, pseudo):
        loss_g, loss_intra, loss_inter = _match_losses(out, batch, pseudo,
                                                       m1, m2, mesh)
        return {'loss': loss_g + loss_intra + loss_inter, 'loss_g': loss_g,
                'loss_intra': loss_intra, 'loss_inter': loss_inter}

    @torch.no_grad()
    def valid_step(batch: Batch, generator: torch.Generator) -> Batch:
        model.eval()
        batch = assemble(batch)
        with rows_of():
            pseudo = _device_pseudo(batch, generator)
        out = _pair_forward(model, batch, pseudo, None)
        pred_f, score, miou = _stats(out['start_prob'], out['end_prob'],
                                     batch, lg_frame2sec)
        return {**losses(out, batch, pseudo), 'miou': miou,
                'pred_time': pred_f, 'score': score}

    @torch.no_grad()
    def grouped(gbatch: Batch, generator: torch.Generator) -> Batch:
        model.eval()
        flat, G, B = _flatten_group(gbatch)
        batch = assemble(flat)
        with rows_of():
            pseudo = _device_pseudo(batch, generator, groups=G)
        out = _pair_forward(model, batch, pseudo, None)

        def rows(d, g):
            return {k: v[g * B:(g + 1) * B] for k, v in d.items()}
        each = [losses(rows(out, g), rows(batch, g), rows(pseudo, g))
                for g in range(G)]
        pred_f, score, iou = _decode(out['start_prob'], out['end_prob'],
                                     batch, lg_frame2sec)
        return {**{k: torch.stack([e[k] for e in each]) for k in each[0]},
                'miou': iou.reshape(G, B).mean(1),
                'pred_time': pred_f.reshape(G, B, 2),
                'score': score.reshape(G, B)}

    valid_step.grouped = grouped
    return valid_step


def make_gmd_test_step(model, lg_frame2sec: bool = False, assembler=None,
                       topk: int = 1, topk_nms_iou: float = 0.5
                       ) -> Callable[[Batch], Batch]:
    """Returns step(batch) -> {loss, miou, pred_time [B, 2], score [B]} on
    the batch's device, from the model in eval mode (no dropout, whatever
    mode a train step left it in). loss and miou average over all B rows,
    padded wrap-around rows included, as the JAX step does. ``topk`` > 1
    adds ``pred_time_topk`` [B, topk, 2] and ``score_topk`` [B, topk],
    the NMS proposals at ``topk_nms_iou``; the top-1 outputs are
    unchanged. ``step.grouped(gbatch)`` takes [G, B, ...] batches in one
    [G*B] pass and returns loss and miou [G] and the outputs [G, B, ...].
    Neither synchronises with the host, so a CUDA graph can capture them."""
    assemble = assembler or _identity

    @torch.no_grad()
    def per_sample(batch: Batch) -> Batch:
        model.eval()
        batch = assemble(batch)
        out = model.eval_forward(batch['video_feat'], batch['sent_feat'],
                                 batch['video_mask'], batch['sent_mask'])
        nll = span_ground_nll(out['start_prob'], out['end_prob'],
                              batch['framestps'])
        pred_f, score, iou = _decode(out['start_prob'], out['end_prob'],
                                     batch, lg_frame2sec)
        res = {'nll': nll, 'iou': iou, 'pred_time': pred_f, 'score': score}
        if topk > 1:
            res['pred_time_topk'], res['score_topk'] = _topk_stats(
                out['start_prob'], out['end_prob'], batch, lg_frame2sec,
                topk, topk_nms_iou)
        return res

    def test_step(batch: Batch) -> Batch:
        out = per_sample(batch)
        return {'loss': out.pop('nll').mean(), 'miou': out.pop('iou').mean(),
                **out}

    def grouped(gbatch: Batch) -> Batch:
        flat, G, B = _flatten_group(gbatch)
        return _regroup(per_sample(flat), G, B)

    test_step.grouped = grouped
    return test_step


def make_baseline_train_step(model, state: TrainState,
                             params: Dict[str, Any],
                             lg_frame2sec: bool = False, assembler=None
                             ) -> Callable[[Batch, torch.Generator], Batch]:
    """Returns step(batch, generator) -> {loss, miou}: one optimizer update
    of ``state`` on the grounding NLL of one batch, with dropout masks from
    the generator. ``step.loss_fn(batch, generator) -> (loss, aux)`` is the
    loss alone."""
    accum = int(params.get('grad_accum_steps', 1) or 1)
    assemble = assembler or _identity

    def loss_fn(batch: Batch, generator):
        out = model(batch['video_feat'], batch['sent_feat'],
                    batch['video_mask'], batch['sent_mask'],
                    generator=generator)
        loss = span_ground_loss(out['start_prob'], out['end_prob'],
                                batch['framestps'])
        return loss, {'loss': loss, 'start_prob': out['start_prob'],
                      'end_prob': out['end_prob']}

    def train_step(batch: Batch, generator: torch.Generator) -> Batch:
        model.train()
        batch = assemble(batch)
        with state.forward_context():
            aux = _backward(lambda b, _pseudo, g: loss_fn(b, g),
                            model.parameters(), batch, {}, generator, accum,
                            _BASELINE_LOSS_KEYS)
        state.apply_gradients()
        *_, miou = _stats(aux['start_prob'].detach(),
                          aux['end_prob'].detach(), batch, lg_frame2sec)
        return _global_means({'loss': aux['loss'].detach(), 'miou': miou},
                             state.mesh)

    train_step.loss_fn = loss_fn
    return train_step


def make_baseline_eval_step(model, lg_frame2sec: bool = False,
                            assembler=None, topk: int = 1,
                            topk_nms_iou: float = 0.5
                            ) -> Callable[[Batch], Batch]:
    """The baseline's valid and test step: ``make_gmd_test_step``'s
    outputs (top-k ones too) and ``grouped`` pass on the model's
    ``eval_forward`` in eval mode, which for the baseline is its forward
    without dropout."""
    return make_gmd_test_step(model, lg_frame2sec, assembler, topk,
                              topk_nms_iou)
