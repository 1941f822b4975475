"""The GMD and QAVE baseline train and test drivers.

Counterpart of ``shufflingvideosfortsg_tpu/cli.py``: ``build_argparser``
and ``parse_params`` (``:50-105``, the same flags and merge rules, plus
``--device``), ``main_train`` with ``run_valid`` and ``_print_statistics``
(``:756-1036``, the per-batch loop), ``main_test`` (``:1041-1113``),
``main_train_baseline`` with ``run_eval_collect`` (``:1120-1273``) and
``main_test_baseline`` (``:1276-1322``).

``--device`` defaults to ``cuda``; without a card the drivers raise rather
than run on the CPU. ``--device cpu`` runs the kernels' plain versions.
Not ported yet, and refused: ``eval_topk > 1``, featpack feature
directories (with the resident bank and its grouped and chunked loops),
``precision: bf16``, and in training ``multi_seed``, ``pipeline_stages``,
``tensor_parallel``, ``fsdp``, ``grad_accum_steps > 1``,
``async_checkpoint`` and ``--start_from auto``. A non-finite training
loss raises at the watchdog's cadence; the JAX watchdog's emergency
checkpoint is not ported.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import DEFAULTS, load_config
from .data.pipeline import BatchLoader, SentenceGroundingDataset
from .eval.iou import retrieval_eval
from .models.build import build_model
from .train.state import TrainState
from .train.steps import (HOST_PAIR_KEYS, STEP_KEYS, TRAIN_KEYS,
                          make_baseline_eval_step, make_baseline_train_step,
                          make_gmd_test_step, make_gmd_train_step,
                          make_gmd_valid_step, to_device)
from .utils.interop import load_reference_ckp
from .utils.saver import RunManager


def build_argparser(default_model: str = 'QAVE_match',
                    suppress: bool = False) -> argparse.ArgumentParser:
    """Argparse surface mirroring the reference flags, plus ``--device``.

    With ``suppress=True`` every default becomes ``argparse.SUPPRESS`` so
    the parsed namespace holds exactly the flags the user typed."""
    p = argparse.ArgumentParser()
    for key, value in DEFAULTS.items():
        flag = '--' + key
        if key == 'model':
            default = argparse.SUPPRESS if suppress else default_model
            p.add_argument(flag, type=str, default=default)
            continue
        default = argparse.SUPPRESS if suppress else value
        if isinstance(value, bool):
            p.add_argument(flag, action='store_true', default=default)
        elif isinstance(value, list):
            p.add_argument(flag, type=int, nargs='+', default=default)
        elif isinstance(value, int):
            p.add_argument(flag, type=int, default=default)
        elif isinstance(value, float):
            p.add_argument(flag, type=float, default=default)
        else:
            p.add_argument(flag, type=str, default=default)
    p.add_argument('--device', type=str,
                   default=argparse.SUPPRESS if suppress else 'cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def parse_params(argv=None, default_model: str = 'QAVE_match') -> Dict[str, Any]:
    """Merge defaults < YAML < explicitly-typed CLI flags (an explicitly
    typed flag wins over the YAML even when it equals the default)."""
    args = vars(build_argparser(default_model).parse_args(argv))
    explicit = vars(build_argparser(default_model, suppress=True)
                    .parse_args(argv))
    cfg = args.pop('cfg', None)
    explicit.pop('cfg', None)
    params = load_config(cfg, overrides=None)
    model = explicit.pop('model', None)
    for k, v in explicit.items():
        if k in DEFAULTS:
            params[k] = v
    params['model'] = model if model is not None else default_model
    params['cfg'] = cfg
    params['device'] = args['device']
    return params


def setup_logger(alias: str) -> logging.Logger:
    logging.basicConfig()
    logger = logging.getLogger(alias)
    logger.setLevel(logging.INFO)
    return logger


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device must exist: the driver never falls
    back to the CPU unless asked for it."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}: no CUDA device is available '
                           '(pass --device cpu to run on the CPU)')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {name!r}')
    return device


def _dataset_kind(name: str) -> str:
    if name in ('charades', 'charades_cd'):
        return 'charades'
    if name in ('anet', 'anet_cd'):
        return 'anet'
    raise ValueError('Error datasetname' + name)


def make_dataset(params, anno_key: str, feat_key: str, kind_key: str):
    ds = SentenceGroundingDataset(params[anno_key], params[feat_key], params,
                                  dataset_name=_dataset_kind(params[kind_key]))
    if params.get('debug'):
        ds.samples = ds.samples[:4 * params['batch_size'][0]]
    return ds


def _collect_predictions(pred_dict, batch, pred_time, score) -> None:
    n = batch['n_valid']  # the last batch is padded with wrap-around rows
    pt_l = np.asarray(pred_time).tolist()
    ts_l = np.asarray(batch['timestps']).tolist()
    sc_l = np.asarray(score, np.float64).tolist()
    dur_l = np.asarray(batch['duration'], np.float64).tolist()
    results = pred_dict['results']
    for i in range(n):
        results.setdefault(batch['vid'][i], []).append({
            'sentence': batch['sentence'][i],
            'timestamp': pt_l[i],
            'gt_timestamp': ts_l[i],
            'score': sc_l[i],
            'video_duration': dur_l[i],
        })


def _new_pred_dict(params):
    return {'version': 'V0', 'results': {},
            'external_data': {'used': True, 'details': 'provided i3D feature'},
            'params': params}


class _PhaseTimer:
    """Wall-clock attribution of a driver run's phases: ``mark(name)``
    charges the time since the previous mark to ``name``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.phases: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (now - self.t)
        self.t = now

    def line(self) -> str:
        total = sum(self.phases.values())
        parts = ' '.join(f'{k}={v:.3f}s' for k, v in self.phases.items())
        return f'driver phases ({total:.3f}s total): {parts}'


def _log_eval_batches(logger, tag, losses: List[float], mious: List[float],
                      interval: int, mean_dt: float) -> None:
    if interval == -1:
        return
    for idx in range(0, len(losses), interval):
        logger.info('%s: epoch[%03d], batch[%04d/%04d], elapsed '
                    'time=%0.2fs, loss: %03.3f, miou: %03.3f', tag, 0, idx,
                    len(losses), mean_dt, losses[idx], mious[idx])


def _seeded_model(params: Dict[str, Any], device: torch.device,
                  kind: str = 'gmd'):
    """The model of ``kind`` with torch's default initialisation under
    ``params['seed']``, built on the CPU (the same weights whatever the
    device) and moved."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(params.get('seed', 123))
        model = build_model(params, kind, device='cpu')
    return model.to(device)


def _refuse_unported_training(params: Dict[str, Any]) -> None:
    refused = {
        'multi_seed': int(params.get('multi_seed', 0) or 0) > 1,
        'pipeline_stages': int(params.get('pipeline_stages', 0) or 0) > 0,
        'tensor_parallel': int(params.get('tensor_parallel', 0) or 0) > 1,
        'fsdp': bool(params.get('fsdp')),
        'grad_accum_steps': int(params.get('grad_accum_steps', 1) or 1) > 1,
        'async_checkpoint': bool(params.get('async_checkpoint')),
        'start_from auto':
            str(params.get('start_from') or '').lower() == 'auto',
    }
    named = [k for k, on in refused.items() if on]
    if named:
        raise NotImplementedError(f'{", ".join(named)}: not ported to the '
                                  'PyTorch trainer yet')


def _avg(metrics_list, key) -> float:
    return float(np.mean([float(m[key]) for m in metrics_list]))


def _fetch(outs: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    return [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]


def main_train(params: Dict[str, Any]) -> Dict[str, Any]:
    """Train GMD for ``params['epoch']`` epochs: a valid pass every
    ``test_interval`` epochs (submit JSON under ``submits/``) and a
    reference ``.ckp`` every ``save_model_interval`` epochs and at the
    end. Returns the loss/mIoU statistics it prints."""
    host_pair = not params.get('on_device_aug', True)

    def steps(model, state, lg, device):
        valid_step = make_gmd_valid_step(model, params, lg)
        # validation draws its pseudo videos from a stream of its own
        valid_gen = torch.Generator(device).manual_seed(
            params.get('seed', 123) + 0x5a11d)

        def validate(loader, logger, epoch, saver):
            return run_valid(valid_step, loader, params, logger, epoch, saver,
                             device, valid_gen)
        return make_gmd_train_step(model, state, params, lg), validate

    return _train(params, 'gmd', steps,
                  HOST_PAIR_KEYS if host_pair else TRAIN_KEYS,
                  ('miou', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'),
                  host_pair)


def main_train_baseline(params: Dict[str, Any]) -> Dict[str, Any]:
    """Train the QAVE baseline on the grounding loss alone, with
    :func:`main_train`'s epochs, valid passes (:func:`run_eval_collect`),
    checkpoints and statistics."""

    def steps(model, state, lg, device):
        eval_step = make_baseline_eval_step(model, lg)

        def validate(loader, logger, epoch, saver):
            return run_eval_collect(eval_step, loader, params, logger, epoch,
                                    saver, device, 'val_data')
        return make_baseline_train_step(model, state, params, lg), validate

    return _train(params, 'baseline', steps, STEP_KEYS, ('miou',))


def _train(params: Dict[str, Any], kind: str, steps, keys, terms,
           host_pair: bool = False) -> Dict[str, Any]:
    """The training loop shared by the drivers. ``steps(model, state, lg,
    device)`` returns (train_step, validate); ``keys`` are the batch keys
    a train step reads and ``terms`` the metrics it logs beside the loss;
    ``host_pair`` has the loader make the pseudo videos."""
    device = resolve_device(params.get('device', 'cuda'))
    _refuse_unported_training(params)
    logger = setup_logger(params['alias'])
    saver = RunManager(params)
    lg = str(params['vfeat_fn']).lower() == 'lg'
    seed = params.get('seed', 123)

    model = _seeded_model(params, device, kind)
    train_set = make_dataset(params, 'train_data', 'train_featpath', 'train')
    valid_set = make_dataset(params, 'val_data', 'valid_featpath', 'valid')
    train_loader = BatchLoader(train_set, params['batch_size'][0],
                               shuffle=True, seed=seed,
                               host_pair_aug=host_pair)
    valid_loader = BatchLoader(valid_set, params['batch_size'][2],
                               shuffle=False)
    if params.get('start_from'):
        model.load_state_dict(load_reference_ckp(params['start_from']))
        logger.warning('resume from checkpoint: %s (weights only)',
                       params['start_from'])
    state = TrainState(model, params, steps_per_epoch=len(train_loader))
    train_step, validate = steps(model, state, lg, device)
    train_gen = torch.Generator(device).manual_seed(seed)

    statistics = {'loss': {}, 'mIoU': {}}
    log_iv = params['batch_log_interval']
    check_iv = params.get('nan_check_interval', 100)
    for epoch in range(params['epoch']):
        t0 = time.time()
        outs = []
        for idx, batch in enumerate(train_loader):
            t_b = time.time()
            metrics = train_step(to_device(batch, device, keys), train_gen)
            outs.append(metrics)
            do_log = log_iv != -1 and idx % log_iv == 0
            if do_log or idx % check_iv == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if do_log:
                    logger.info(
                        'train: epoch[%03d], batch[%04d/%04d], elapsed '
                        'time=%0.2fs, %s', epoch, idx, len(train_loader),
                        time.time() - t_b, ', '.join(
                            f'{k}: {m[k]:03.3f}' for k in ('loss',) + terms))
                if not math.isfinite(m['loss']):
                    raise FloatingPointError(
                        f'non-finite loss {m["loss"]} at epoch {epoch} batch '
                        f'{idx}')
        fetched = _fetch(outs)
        avg_loss = _avg(fetched, 'loss')
        epoch_secs = time.time() - t0
        logger.info('epoch [%03d]: elapsed time:%0.2fs, avg loss: %03.3f, '
                    'miou: %03.3f', epoch, epoch_secs, avg_loss,
                    _avg(fetched, 'miou'))
        saver.log_metrics({'epoch': epoch, 'phase': 'train',
                           'seconds': epoch_secs, 'loss': avg_loss,
                           **{k: _avg(fetched, k) for k in terms}})
        if (epoch + 1) % params['test_interval'] == 0 or epoch == 0:
            statistics['loss'][epoch] = round(avg_loss, 3)
        if (epoch + 1) % params['test_interval'] == 0:
            miou = validate(valid_loader, logger, epoch, saver)
            saver.log_metrics({'epoch': epoch, 'phase': 'valid',
                               'miou': miou})
            statistics['mIoU'][epoch] = round(miou * 100, 2)
        if ((epoch + 1) % params['save_model_interval'] == 0
                or epoch + 1 == params['epoch']):
            logger.info('Save model in %s',
                        saver.save_checkpoint(epoch, model))
    _print_statistics(statistics)
    return statistics


def run_valid(valid_step, loader, params, logger, epoch: int,
              saver: Optional[RunManager], device: torch.device,
              generator: torch.Generator) -> float:
    """One valid pass: losses, the submit JSON, the mean IoU it returns."""
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, outs = [], []
    for batch in loader:
        host_batches.append(batch)
        outs.append(valid_step(to_device(batch, device, TRAIN_KEYS),
                               generator))
    fetched = _fetch(outs)
    for batch, f in zip(host_batches, fetched):
        _collect_predictions(pred_dict, batch, f['pred_time'], f['score'])
    if saver is not None:
        saver.save_submits(pred_dict, epoch, 'val_data')
    miou = _avg(fetched, 'miou')
    logger.info('epoch [%03d]: elapsed time:%0.4fs, avg loss: %03.3f, '
                'miou: %03.3f avg loss_g: %03.3f, avg loss_m1: %03.3f, '
                'avg loss_m2: %03.3f', epoch, time.time() - t0,
                _avg(fetched, 'loss'), miou, _avg(fetched, 'loss_g'),
                _avg(fetched, 'loss_intra'), _avg(fetched, 'loss_inter'))
    return miou


def run_eval_collect(eval_step, loader, params, logger, epoch: int,
                     saver: Optional[RunManager], device: torch.device,
                     submit_key: str) -> float:
    """The baseline's valid pass: the submit JSON under ``submit_key``'s
    split and the mean IoU it returns."""
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, outs = [], []
    for batch in loader:
        host_batches.append(batch)
        outs.append(eval_step(to_device(batch, device)))
    fetched = _fetch(outs)
    for batch, f in zip(host_batches, fetched):
        _collect_predictions(pred_dict, batch, f['pred_time'], f['score'])
    if saver is not None:
        saver.save_submits(pred_dict, epoch, submit_key)
    miou = _avg(fetched, 'miou')
    logger.info('epoch [%03d]: elapsed time:%0.4fs, avg loss: %03.3f, '
                'miou: %03.3f', epoch, time.time() - t0,
                _avg(fetched, 'loss'), miou)
    return miou


def _print_statistics(statistics) -> None:
    for title in ('loss', 'mIoU'):
        print(title, ':')
        print('\t'.join(str(k) for k in statistics[title].keys()))
        print('\t'.join(str(v) for v in statistics[title].values()))
        if title == 'mIoU' and statistics[title]:
            keys = list(statistics[title].keys())
            vals = list(statistics[title].values())
            print('Max mIoU:', max(vals), '\tEpoch',
                  keys[vals.index(max(vals))])


def main_test(params: Dict[str, Any]) -> str:
    """Evaluate GMD on ``test_data``: write the submit JSON (and its
    ``.metrics.json``), print the retrieval table, return the submit path."""
    return _test(params, 'gmd', make_gmd_test_step)


def main_test_baseline(params: Dict[str, Any]) -> str:
    """:func:`main_test` for the QAVE baseline."""
    return _test(params, 'baseline', make_baseline_eval_step)


def _test(params: Dict[str, Any], kind: str, make_step) -> str:
    device = resolve_device(params.get('device', 'cuda'))
    if int(params.get('eval_topk', 1) or 1) > 1:
        raise NotImplementedError('eval_topk > 1 is not ported yet')
    pt = _PhaseTimer()
    logger = setup_logger(params['alias'])
    saver = RunManager(params)
    lg = str(params['vfeat_fn']).lower() == 'lg'

    model = _seeded_model(params, torch.device('cpu'), kind)
    pt.mark('setup')
    test_set = make_dataset(params, 'test_data', 'test_featpath', 'test')
    test_loader = BatchLoader(test_set, params['batch_size'][0],
                              shuffle=False)
    pt.mark('dataset')
    if params.get('start_from'):
        model.load_state_dict(load_reference_ckp(params['start_from']))
        logger.warning('use checkpoint: %s', params['start_from'])
    model = model.to(device).eval()
    pt.mark('init')

    test_step = make_step(model, lg)
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, outs = [], []
    for batch in test_loader:
        host_batches.append(batch)
        outs.append(test_step(to_device(batch, device)))
    fetched = _fetch(outs)
    pt.mark('eval_loop')
    losses = [float(f['loss']) for f in fetched]
    mious = [float(f['miou']) for f in fetched]
    _log_eval_batches(logger, 'test', losses, mious,
                      params['batch_log_interval'],
                      (time.time() - t0) / max(len(host_batches), 1))
    for batch, f in zip(host_batches, fetched):
        _collect_predictions(pred_dict, batch, f['pred_time'], f['score'])
    submit = saver.save_submits(pred_dict, 0, 'test_data')
    # the reference's "elapsed time": eval loop + decode + collect +
    # submit write; not the model build, checkpoint load or scoring
    loop_s = time.time() - t0
    logger.info('epoch [%03d]: elapsed time:%0.4fs, avg loss: %03.3f, '
                'miou: %03.3f', 0, loop_s, float(np.mean(losses)),
                float(np.mean(mious)))
    pt.mark('collect_submit')
    metrics = retrieval_eval(submit)
    metrics['elapsed_loop_s'] = round(loop_s, 4)
    with open(submit + '.metrics.json', 'w') as f:
        json.dump(metrics, f)
    pt.mark('score')
    logger.info(pt.line())
    return submit
