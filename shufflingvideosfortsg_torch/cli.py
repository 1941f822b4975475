"""The GMD evaluation driver.

Counterpart of ``shufflingvideosfortsg_tpu/cli.py``: ``build_argparser``
and ``parse_params`` (``:50-105``, the same flags and merge rules, plus
``--device``) and ``main_test`` (``:1041-1113``). The training drivers
arrive with the training slice.

``--device`` defaults to ``cuda``; without a card the driver raises rather
than run on the CPU. ``--device cpu`` runs the kernels' plain versions.
Not ported yet, and refused: ``eval_topk > 1``, featpack feature
directories (with the resident bank and its grouped eval loop) and
``precision: bf16``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .config import DEFAULTS, load_config
from .data.pipeline import BatchLoader, SentenceGroundingDataset
from .eval.iou import retrieval_eval
from .models.build import build_model
from .train.steps import make_gmd_test_step, to_device
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


def main_test(params: Dict[str, Any]) -> str:
    """Evaluate GMD on ``test_data``: write the submit JSON (and its
    ``.metrics.json``), print the retrieval table, return the submit path."""
    device = resolve_device(params.get('device', 'cuda'))
    if int(params.get('eval_topk', 1) or 1) > 1:
        raise NotImplementedError('eval_topk > 1 is not ported yet')
    pt = _PhaseTimer()
    logger = setup_logger(params['alias'])
    saver = RunManager(params)
    lg = str(params['vfeat_fn']).lower() == 'lg'

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(params.get('seed', 123))
        model = build_model(params, 'gmd', device='cpu')
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

    test_step = make_gmd_test_step(model, lg)
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, outs = [], []
    for batch in test_loader:
        host_batches.append(batch)
        outs.append(test_step(to_device(batch, device)))
    fetched = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]
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
