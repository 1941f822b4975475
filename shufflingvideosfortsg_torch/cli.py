"""The GMD and QAVE baseline train and test drivers.

Counterpart of ``shufflingvideosfortsg_tpu/cli.py``: ``build_argparser``
and ``parse_params`` (``:50-105``, the same flags and merge rules, plus
``--device``), ``main_train`` with ``run_valid`` and ``_print_statistics``
(``:756-1036``), ``main_test`` (``:1041-1113``),
``main_train_baseline`` with ``run_eval_collect`` (``:1120-1273``) and
``main_test_baseline`` (``:1276-1322``).

``--device`` defaults to ``cuda``; without a card the drivers raise rather
than run on the CPU. ``--device cpu`` runs the kernels' plain versions.

A featpack feature directory puts its pack on the device
(``data/device_bank.maybe_device_bank``, unless ``device_bank`` is off,
the pack is over ``device_bank_max_gb`` or a train set has ``if_aug``):
batches then carry indices and are assembled on the device. An evaluation
with such a bank (``_banked_eval_epoch``, JAX ``cli.py:390``) uploads the
index arrays of the whole split once and runs ``eval_scan_group`` loader
batches a tick as one ``[G*B]`` pass, GMD's valid pass too (its pseudo
videos drawn from its ``torch.Generator`` batch after batch); GMD
training on a bank with ``train_scan_chunk`` > 1
(``_banked_train_chunks_factory``, JAX ``cli.py:575``) uploads a chunk's
index arrays once and runs its steps one after another, logging and
checking the loss at chunk boundaries. On a card a tick and a train step
are each one replay of a CUDA graph (``_GraphedTick``, its first calls
eager), the port's counterpart of JAX's ``lax.scan``; the generator is
registered with the graph, so a graphed run draws and computes what the
eager one does, bit for bit. The QAVE baseline trains batch by batch, as
JAX's ``main_train_baseline`` does.

``eval_topk`` > 1 writes each sentence's top-k NMS proposals
(``timestamps_topk``, ``scores_topk``; finite scores only) into the
submit beside the top-1 span, and the retrieval table gains its R@k rows.

``precision: bf16`` runs the train and test drivers (and the grounder) in
bf16 with f32 weights and f32 optimizer state, as the JAX package does,
cuBLAS's bf16 products summed in f32 (``utils/device.exact_bf16_products``).

Training checkpoints hold the full trainer state (``utils/saver.py``: the
reference ``.ckp`` and its sidecar), written in the background with
``async_checkpoint``. ``--start_from <ckp>`` restores the weights and,
where the sidecar exists, the optimizer's state, the update count and the
generators; ``--start_from auto`` resumes from the alias's newest
checkpoint at the next epoch (``_resolve_auto_resume``, JAX
``cli.py:644``). As in JAX the loader's shuffle restarts at its first
epoch order on resume (JAX ``data/pipeline.py:291``). A non-finite
training loss writes ``<alias>_99999.ckp`` and its sidecar, then raises
(``_check_finite``, JAX ``cli.py:277``). ``grad_accum_steps`` > 1 takes
each update's gradient over that many microbatches
(``train/steps._backward``). ``SVTSG_TRACE_DIR=<dir>`` traces a training
run with ``torch.profiler`` and writes a Chrome trace there.

``multi_seed`` S > 1 trains S seeds at once (``_multiseed_setup``, JAX
``cli.py:293-350``; ``train/multiseed.py``): one step updates every seed
from the shared batch, each seed with its own weights, optimizer state
and train generator, and returns the seeds' mean metrics, so logging,
the chunks and the watchdog run as for one seed. On a card a chunk's
step captures all S updates in one CUDA graph. Each valid pass runs per
seed (submits ``<split>.s{i}``, ``miou_per_seed`` in ``metrics.jsonl``,
their mean in the statistics), every seed drawing the same pseudo
videos, and checkpoints are written per seed as
``<alias>_<epoch:05d>_s{i}.ckp`` with their sidecars. As in JAX it
refuses ``fsdp`` and ``start_from``, and a non-finite loss writes no
emergency checkpoint. S = 1 is a single-seed run. Not ported yet, and
refused in training: ``pipeline_stages``, ``tensor_parallel`` and
``fsdp``.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULTS, load_config
from .data.device_bank import INDEX_KEYS, maybe_device_bank
from .data.pipeline import BatchLoader, SentenceGroundingDataset
from .eval.iou import retrieval_eval
from .models.build import build_model
from .train.multiseed import (init_multiseed_states,
                              make_multiseed_train_step,
                              make_multiseed_valid_step, n_seeds_of, seed_of,
                              unstack_state)
from .train.state import TrainState
from .train.steps import (HOST_PAIR_KEYS, STEP_KEYS, TRAIN_KEYS,
                          make_baseline_eval_step, make_baseline_train_step,
                          make_gmd_test_step, make_gmd_train_step,
                          make_gmd_valid_step, to_device)
from .utils.device import exact_bf16_products, resolve_device
from .utils.interop import load_reference_ckp
from .utils.saver import RunManager, latest_checkpoint, load_checkpoint


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


def _collect_predictions(pred_dict, batch, pred_time, score,
                         pred_topk=None, score_topk=None) -> None:
    n = batch['n_valid']  # the last batch is padded with wrap-around rows
    pt_l = np.asarray(pred_time).tolist()
    ts_l = np.asarray(batch['timestps']).tolist()
    sc_l = np.asarray(score, np.float64).tolist()
    dur_l = np.asarray(batch['duration'], np.float64).tolist()
    results = pred_dict['results']
    for i in range(n):
        entry = {
            'sentence': batch['sentence'][i],
            'timestamp': pt_l[i],
            'gt_timestamp': ts_l[i],
            'score': sc_l[i],
            'video_duration': dur_l[i],
        }
        if pred_topk is not None:
            # the R@k proposals (eval_topk > 1), finite scores only: NMS
            # pads an exhausted pool with -inf repeats
            keep = np.isfinite(np.asarray(score_topk[i]))
            entry['timestamps_topk'] = np.asarray(pred_topk[i])[keep].tolist()
            entry['scores_topk'] = np.asarray(score_topk[i])[keep].tolist()
        results.setdefault(batch['vid'][i], []).append(entry)


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
                  kind: str = 'gmd', index: int = 0):
    """The model of ``kind`` with torch's default initialisation under
    ``params['seed']`` (seed ``index`` of a multi-seed run: under
    ``seed_of(params['seed'], index)``, so index 0 is the single-seed
    model), built on the CPU (the same weights whatever the device) and
    moved."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed_of(params.get('seed', 123), index))
        model = build_model(params, kind, device='cpu')
    return model.to(device)


def _multiseed_validate(params: Dict[str, Any]) -> int:
    """Check ``--multi_seed`` combinations up front (JAX ``cli.py:293``),
    before any checkpoint or run directory is touched. Returns S (0/1 =
    off)."""
    S = int(params.get('multi_seed', 0) or 0)
    if S <= 1:
        return S
    if params.get('fsdp'):
        raise ValueError('--multi_seed does not compose with --fsdp: the '
                         'stacked seed axis changes every leaf shape the '
                         'ZeRO-3 placement rule keys on')
    if params.get('start_from'):
        raise ValueError('--multi_seed cannot resume (--start_from): '
                         'checkpoints are written per seed; restart the '
                         'study or train the single seed you want')
    return S


def _seed_mean(fn):
    """``fn`` (a multi-seed step: [S] metrics) with its metrics meaned over
    the seeds, as JAX's ``mean_step``: a NaN in any seed shows in the
    mean."""
    def mean(batch, *generators):
        return {k: v.mean(0) for k, v in fn(batch, *generators).items()}
    return mean


def _multiseed_step(steps):
    """The multi-seed train step over the seeds' ``steps``
    (``make_multiseed_train_step``) with its metrics meaned over the
    seeds, and its ``inner`` and ``state`` where the seeds' steps have
    them: what :func:`_train` and the chunks take for one seed's step."""
    multi = make_multiseed_train_step(steps, len(steps))
    step = _seed_mean(multi)
    if hasattr(multi, 'inner'):
        step.inner, step.state = _seed_mean(multi.inner), multi.state
    return step


def _multiseed_setup(params: Dict[str, Any], kind: str,
                     device: torch.device, lg: bool, banks,
                     steps_per_epoch: int, logger):
    """The run's seeds (JAX ``cli.py:310``): a :class:`MultiSeedState` of
    S seeds with ``multi_seed`` S > 1, of the one seed otherwise, seed i's
    model built by :func:`_seeded_model` (..., i), so seed 0 is the
    single-seed model; and each seed's train and valid step
    (:func:`_seed_steps`), the train step carrying as ``generator`` the
    seed's train generator, seeded with ``seed_of(seed, i)`` (the run's
    ``seed`` for seed 0). Returns (the state, the train steps, the valid
    steps, S), S == 0 when off."""
    S = _multiseed_validate(params)
    n_seeds = S if S > 1 else 0
    stacked = init_multiseed_states(
        lambda i: _seeded_model(params, device, kind, i),
        range(max(n_seeds, 1)), params, steps_per_epoch)
    train_steps, valid_steps = [], []
    for i in range(n_seeds_of(stacked)):
        state = unstack_state(stacked, i)
        train_step, valid_step = _seed_steps(params, kind, state.model,
                                             state, lg, *banks)
        train_step.generator = torch.Generator(device).manual_seed(
            seed_of(params.get('seed', 123), i))
        train_steps.append(train_step)
        valid_steps.append(valid_step)
    if n_seeds:
        logger.info('multi-seed: %d seeds, one train step updates each in '
                    'turn; validation and checkpoints run per seed', n_seeds)
    return stacked, train_steps, valid_steps, n_seeds


def _refuse_unported_training(params: Dict[str, Any]) -> None:
    refused = {
        'pipeline_stages': int(params.get('pipeline_stages', 0) or 0) > 0,
        'tensor_parallel': int(params.get('tensor_parallel', 0) or 0) > 1,
        'fsdp': bool(params.get('fsdp')),
    }
    named = [k for k, on in refused.items() if on]
    if named:
        raise NotImplementedError(f'{", ".join(named)}: not ported to the '
                                  'PyTorch trainer yet')


def _resolve_auto_resume(params: Dict[str, Any]):
    """``--start_from auto`` (JAX ``cli.py:644-657``): the alias's newest
    checkpoint becomes ``start_from``. Returns (reuse the run directory,
    first epoch): (True, its epoch + 1), or with no checkpoint yet a fresh
    start at epoch 0 that reuses the directory if it exists. Any other
    ``start_from`` gives (False, 0)."""
    if str(params.get('start_from') or '').lower() != 'auto':
        return False, 0
    model_dir = os.path.join(params['runs'], params['alias'], 'model')
    found = latest_checkpoint(model_dir)
    if found is None:
        params['start_from'] = None
        return os.path.isdir(os.path.dirname(model_dir)), 0
    params['start_from'] = found[0]
    return True, found[1] + 1


def _check_finite(loss: float, saver: RunManager, model, state, generators,
                  logger, epoch: int, idx: int) -> None:
    """The watchdog (JAX ``cli.py:277-290``): on a non-finite loss write
    the emergency checkpoint ``<alias>_99999.ckp`` and its sidecar
    synchronously, log its path and raise ``FloatingPointError``."""
    if math.isfinite(loss):
        return
    path = saver.save_checkpoint(saver.model_path(99999), model, state,
                                 generators, sync=True)
    logger.error('non-finite loss %s at epoch %d batch %d; emergency '
                 'checkpoint saved to %s', loss, epoch, idx, path)
    raise FloatingPointError(f'non-finite loss {loss} at epoch {epoch} '
                             f'batch {idx}')


def _start_trace(device: torch.device):
    """With ``SVTSG_TRACE_DIR`` set, a started ``torch.profiler`` trace
    (CPU and, on a card, CUDA activities) of the training run (JAX
    ``cli.py:628-641``); otherwise None."""
    if not os.environ.get('SVTSG_TRACE_DIR'):
        return None
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, alias: str, device: torch.device) -> None:
    """Stop :func:`_start_trace`'s trace and write it as the Chrome trace
    ``$SVTSG_TRACE_DIR/<alias>.pt.trace.json``."""
    if prof is None:
        return
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    out = os.environ['SVTSG_TRACE_DIR']
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f'{alias}.pt.trace.json'))


def _avg(fetched: Dict[str, np.ndarray], key, weights=None) -> float:
    return float(np.average([float(m) for m in fetched[key]],
                            weights=weights))


def _fetch(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Per-batch outputs -> {key: [n_batches, ...]} on the host."""
    return {k: torch.stack([o[k] for o in outs]).cpu().numpy()
            for k in outs[0]}


def _device_batch(batch, device: torch.device, keys, bank):
    """A host batch on the device: ``keys`` of it, or with a bank its
    index keys with the bank's tensors attached."""
    if bank is None:
        return to_device(batch, device, keys)
    return bank.attach(to_device(batch, device, INDEX_KEYS))


class _GraphedTick:
    """A CUDA graph of ``fn`` (a dict of tensors -> a dict of tensors)
    built from real calls. The first ``WARMUP`` calls run ``fn`` eagerly
    on a side stream: they build the kernels, fill the launch plans'
    caches and create the cuBLAS handles and workspaces (the autograd
    thread's too) and an optimizer's state, none of which a capture may
    do (a multi-seed step's: every seed's). The next call captures ``fn``
    on the side stream over static buffers shaped like its inputs, with
    the ``generators`` it draws from (one, or a multi-seed step's one a
    seed) registered so each replay draws what an eager call would, and
    replays it; every later call copies its inputs into the buffers on
    the device and replays. Each run is a real call, so ``fn`` may change
    state (a train step, a step that draws from a generator): nothing is run on
    throwaway inputs. The outputs of a replay are the graph's static
    tensors, overwritten by the next one. A failed capture raises."""

    WARMUP = 2  # eager calls before the capture

    def __init__(self, fn, generators: Tuple[torch.Generator, ...] = ()):
        self.fn = fn
        self.generators = generators
        self.calls = 0
        self.graph = None

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        self.calls += 1
        if self.graph is None:
            device = next(iter(inputs.values())).device
            current = torch.cuda.current_stream(device)
            if self.calls == 1:
                self.side = torch.cuda.Stream(device=device)
            self.side.wait_stream(current)
            if self.calls <= self.WARMUP:
                with torch.cuda.stream(self.side):
                    out = self.fn(inputs)
                current.wait_stream(self.side)
                return out
            self.static_in = {k: v.clone() for k, v in inputs.items()}
            # a graph left in a dead reference cycle (a step's graphs
            # refer back to the step) must not be freed by the collector
            # during this capture, which that would invalidate: torch no
            # longer collects before a capture
            gc.collect()
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, stream=self.side):
                self.static_out = self.fn(self.static_in)
            self.graph = graph
        else:
            for k, v in inputs.items():
                self.static_in[k].copy_(v)
        self.graph.replay()
        return self.static_out


def _tick_runner(step, fn, shapes, bank, device: torch.device,
                 graphed: bool,
                 generators: Tuple[torch.Generator, ...] = ()):
    """``fn`` itself, or on a card with ``graphed`` its :class:`_GraphedTick`
    over ``generators``, kept on ``step`` by (input shapes, bank,
    generators): captured once per step and key, its memory pool kept
    with it."""
    if not (graphed and device.type == 'cuda'):
        return fn
    cache = step.__dict__.setdefault('graphs', {})
    key = (shapes, bank.key(), bank.feats.data_ptr(), generators)
    if key not in cache:
        cache[key] = _GraphedTick(fn, generators)
    return cache[key]


def _stack_indices(host_batches, group: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """The index arrays of ``host_batches`` as [n, B, ...], or with a
    ``group`` G as [n_ticks, G, B, ...] with the last tick padded by
    repeating the last batch."""
    arrays = {k: np.stack([np.asarray(b[k]) for b in host_batches])
              for k in INDEX_KEYS}
    if group is not None:
        pad = -len(host_batches) % group
        if pad:
            arrays = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                      for k, v in arrays.items()}
        arrays = {k: v.reshape((-1, group) + v.shape[1:])
                  for k, v in arrays.items()}
    return arrays


def _upload(arrays: Dict[str, np.ndarray], device: torch.device):
    """``arrays`` on the device, and their shapes past the first axis (a
    graph's key)."""
    dev = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    shapes = tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in dev.items())
    return dev, shapes


def _banked_eval_epoch(step, host_batches, bank, device: torch.device,
                       timer: Optional['_PhaseTimer'] = None,
                       group: int = 1, graphed: bool = True,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, np.ndarray]:
    """A whole eval epoch on a device bank (JAX ``cli.py:390``): the index
    arrays of every batch go up once as [n_ticks, G, B, ...] (the last
    tick padded by repeating the last batch), each tick runs
    ``step.grouped`` on G batches (the bank's assembly, the [G*B] pass,
    the per-batch means) and its outputs are copied on the device, fetched
    once at the end and cut back to the real batches. With ``generator``
    (a valid step's pseudo draws, batch after batch) a tick draws for
    each of its batches, so the last tick is not padded: its batches run
    as one shorter tick of their own, eagerly, and the epoch draws what
    the step batch by batch does.

    On a card with ``graphed`` the full ticks run through a
    :class:`_GraphedTick` kept on the step (:func:`_tick_runner`).
    Otherwise (the CPU, or ``graphed=False``) every tick runs eagerly.

    Phase marks, as JAX's: ``eval_stack``, ``eval_upload``,
    ``eval_build`` (in the epoch that builds the graph: its eager warm-up
    ticks, the capture and the first replay, waited for on the card) and
    ``eval_exec`` (every other tick and the fetch)."""

    def mark(name):
        if timer is not None:
            timer.mark(name)

    n_real = len(host_batches)
    group = max(1, min(int(group), n_real))
    n_full = n_real - n_real % group if generator is not None else n_real
    arrays = _stack_indices(host_batches[:n_full], group)
    tail = host_batches[n_full:]
    if tail:
        tail = _stack_indices(tail, len(tail))
    mark('eval_stack')
    dev, shapes = _upload(arrays, device)
    if tail:
        tail, _ = _upload(tail, device)
    mark('eval_upload')

    def tick_fn(tick):
        tick = bank.attach(tick)
        if generator is None:
            return step.grouped(tick)
        return step.grouped(tick, generator)

    run = _tick_runner(step, tick_fn, shapes, bank, device, graphed,
                       () if generator is None else (generator,))
    outs = []
    for i in range(next(iter(dev.values())).shape[0]):
        building = getattr(run, 'graph', False) is None
        out = run({k: v[i] for k, v in dev.items()})
        outs.append({k: v.clone() for k, v in out.items()})
        if building and run.graph is not None:
            torch.cuda.synchronize(device)
            mark('eval_build')
    if tail:
        outs.append(tick_fn({k: v[0] for k, v in tail.items()}))
    fetched = {k: torch.cat([o[k] for o in outs]).cpu().numpy()[:n_real]
               for k in outs[0]}
    mark('eval_exec')
    return fetched


def _eval_epoch(step, loader, bank, device: torch.device,
                keys=STEP_KEYS, generator: Optional[torch.Generator] = None,
                timer: Optional['_PhaseTimer'] = None, group: int = 1,
                _graphed: bool = True):
    """One eval pass over ``loader``: (host batches, {key: [n_batches,
    ...]} on the host). With a bank and a step that has a grouped pass,
    :func:`_banked_eval_epoch`; otherwise batch by batch (assembled on the
    device where there is a bank), fetched once. ``generator`` feeds a
    valid step's pseudo-video draws. ``_graphed=False`` runs the banked
    epoch's ticks without a graph (for comparisons)."""
    if bank is not None and hasattr(step, 'grouped'):
        host_batches = list(loader)
        return host_batches, _banked_eval_epoch(
            step, host_batches, bank, device, timer, group, _graphed,
            generator)
    host_batches, outs = [], []
    for batch in loader:
        host_batches.append(batch)
        b = _device_batch(batch, device, keys, bank)
        outs.append(step(b) if generator is None else step(b, generator))
    return host_batches, _fetch(outs)


def _banked_train_chunks_factory(train_step, bank, device: torch.device,
                                 graphed: bool = True):
    """Chunked training on a device bank (JAX ``cli.py:575``): returns
    run(host_chunk, *generators) -> {metric: chunk mean, a 0-d tensor on
    the device}, which takes the K loader batches of ``host_chunk`` as K
    updates of ``train_step.state`` (a multi-seed step's: every seed's,
    with one generator a seed). The chunk's index arrays go up once as
    [K, B, ...]; the rate is set once (a chunk never straddles an epoch,
    and the schedule is epoch-granular); each update runs
    ``train_step.inner`` on the bank and the generators, and counts
    itself; its metrics are kept on the device, [K] of each. So a chunk
    draws from the generators and updates the weights exactly as K calls
    of the step would.

    On a card with ``graphed`` the updates run through a
    :class:`_GraphedTick` kept on the step (:func:`_tick_runner`): the
    epoch's first updates warm up eagerly, the next is captured, and every
    later one, the tail chunk's too, is a replay of that graph. Otherwise
    every update runs eagerly."""
    state = train_step.state

    def run(host_chunk, *generators: torch.Generator):
        dev, shapes = _upload(_stack_indices(host_chunk), device)

        def update(batch):
            return train_step.inner(bank.attach(batch), *generators)

        step = _tick_runner(train_step, update, shapes, bank, device,
                            graphed, generators)
        state.set_lr()
        outs = []
        for i in range(len(host_chunk)):
            out = step({k: v[i] for k, v in dev.items()})
            state.step += 1
            outs.append({k: v.clone() for k, v in out.items()})
        return {k: torch.stack([o[k] for o in outs]).mean() for k in outs[0]}

    return run


def main_train(params: Dict[str, Any], _graphed: bool = True
               ) -> Dict[str, Any]:
    """Train GMD for ``params['epoch']`` epochs: a valid pass every
    ``test_interval`` epochs (submit JSON under ``submits/``) and a
    reference ``.ckp`` every ``save_model_interval`` epochs and at the
    end. Returns the loss/mIoU statistics it prints. With the train set
    on a device bank and ``train_scan_chunk`` > 1 an epoch runs in chunks
    (:func:`_banked_train_chunks_factory`), and a valid set on a bank in
    grouped ticks; on a card both run as CUDA graphs, unless
    ``_graphed=False`` (for comparisons). The train step carries the
    run's generators, ``generator`` and ``valid_generator`` (under
    ``multi_seed`` each seed's step its own train generator and the
    shared valid one)."""
    host_pair = not params.get('on_device_aug', True)
    return _train(params, 'gmd',
                  HOST_PAIR_KEYS if host_pair else TRAIN_KEYS,
                  ('miou', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'),
                  host_pair, graphed=_graphed)


def main_train_baseline(params: Dict[str, Any]) -> Dict[str, Any]:
    """Train the QAVE baseline on the grounding loss alone, with
    :func:`main_train`'s epochs, valid passes (:func:`run_eval_collect`),
    checkpoints, statistics and ``multi_seed``."""
    return _train(params, 'baseline', STEP_KEYS, ('miou',))


def _seed_steps(params: Dict[str, Any], kind: str, model, state, lg: bool,
                train_bank, valid_bank):
    """(train step, valid step) of ``kind`` over one seed's model."""
    if kind == 'gmd':
        return (make_gmd_train_step(model, state, params, lg,
                                    _assembler(train_bank)),
                make_gmd_valid_step(model, params, lg,
                                    _assembler(valid_bank)))
    return (make_baseline_train_step(model, state, params, lg,
                                     _assembler(train_bank)),
            make_baseline_eval_step(model, lg, _assembler(valid_bank)))


def _chunks(loader, size: int):
    """The loader's batches in lists of ``size``, the last one shorter."""
    pending = []
    for batch in loader:
        pending.append(batch)
        if len(pending) == size:
            yield pending
            pending = []
    if pending:
        yield pending


def _train(params: Dict[str, Any], kind: str, keys, terms,
           host_pair: bool = False, graphed: bool = True) -> Dict[str, Any]:
    """The training loop shared by the drivers, of ``kind`` 'gmd' or
    'baseline' (:func:`_seed_steps`; valid passes :func:`run_valid` or
    :func:`run_eval_collect`). ``keys`` are the batch keys a train step
    reads without a bank and ``terms`` the metrics it logs beside the
    loss; ``host_pair`` has the loader make the pseudo videos (and keeps
    the train set off the bank). With a train step that has a chunked
    form (``step.inner``, GMD's) and a train bank, ``train_scan_chunk``
    steps run as one chunk (``graphed`` on a card), logged and checked at
    chunk boundaries as JAX's ``flush`` does (``cli.py:864-889``), the
    epoch's means weighted by chunk size. GMD's valid pass draws its
    pseudo videos from a generator of its own. The train generator goes
    on the step as ``generator``, the valid one as ``valid_generator``.
    With ``multi_seed`` S > 1 (:func:`_multiseed_setup`) every step
    updates the S seeds, and the valid passes and checkpoints run per
    seed, each seed's valid pass drawing what seed 0's does
    (``make_multiseed_valid_step``)."""
    _multiseed_validate(params)
    device = resolve_device(params.get('device', 'cuda'))
    _refuse_unported_training(params)
    if device.type == 'cuda':
        exact_bf16_products()
    logger = setup_logger(params['alias'])
    allow_existing, start_epoch = _resolve_auto_resume(params)
    saver = RunManager(params, allow_existing=allow_existing)
    lg = str(params['vfeat_fn']).lower() == 'lg'
    seed = params.get('seed', 123)

    train_set = make_dataset(params, 'train_data', 'train_featpath', 'train')
    valid_set = make_dataset(params, 'val_data', 'valid_featpath', 'valid')
    train_bank = None if host_pair else \
        maybe_device_bank(params, train_set, device, logger)
    valid_bank = maybe_device_bank(params, valid_set, device, logger)
    train_loader = BatchLoader(train_set, params['batch_size'][0],
                               shuffle=True, seed=seed,
                               host_pair_aug=host_pair,
                               device_assemble=train_bank is not None)
    valid_loader = BatchLoader(valid_set, params['batch_size'][2],
                               shuffle=False,
                               device_assemble=valid_bank is not None)
    stacked, train_steps, valid_steps, n_seeds = _multiseed_setup(
        params, kind, device, lg, (train_bank, valid_bank),
        len(train_loader), logger)
    valid_gen = None
    if kind == 'gmd':
        # validation draws its pseudo videos from a stream of its own
        valid_gen = torch.Generator(device).manual_seed(seed + 0x5a11d)
        for step in train_steps:
            step.valid_generator = valid_gen

    def generators(i):
        """Seed ``i``'s generators, as its checkpoints hold them."""
        gens = {'train': train_steps[i].generator}
        if valid_gen is not None:
            gens['valid'] = valid_gen
        return gens

    if params.get('start_from'):
        # one seed (a multi-seed run refuses to resume), restored in place
        # before the first step, so before any graph is captured
        state = unstack_state(stacked, 0)
        weights, resume, weights_only = load_checkpoint(params['start_from'])
        state.model.load_state_dict(weights)
        if resume is not None:
            state.load_state_dict(resume['train_state'])
            for name, gen_state in resume['generators'].items():
                generators(0)[name].set_state(gen_state)
        logger.warning('resume from checkpoint: %s (reference-format=%s, '
                       'step=%s)', params['start_from'], weights_only,
                       state.step)
    train_step = (_multiseed_step(train_steps) if n_seeds
                  else train_steps[0])
    train_gens = tuple(step.generator for step in train_steps)
    chunk = int(params.get('train_scan_chunk', 16))
    run_chunk = None
    if hasattr(train_step, 'inner') and train_bank is not None and chunk > 1:
        run_chunk = _banked_train_chunks_factory(train_step, train_bank,
                                                 device, graphed)

    statistics = {'loss': {}, 'mIoU': {}}
    log_iv = params['batch_log_interval']
    check_iv = params.get('nan_check_interval', 100)
    n_batches = len(train_loader)

    def validate(i, epoch, generator=None):
        """Seed ``i``'s valid pass: its mIoU."""
        suffix = f'.s{i}' if n_seeds else ''
        if kind == 'gmd':
            return run_valid(valid_steps[i], valid_loader, params, logger,
                             epoch, saver, device, generator, valid_bank,
                             graphed, suffix)
        return run_eval_collect(valid_steps[i], valid_loader, params,
                                logger, epoch, saver, device,
                                'val_data' + suffix, valid_bank)
    valid_passes = make_multiseed_valid_step(
        [functools.partial(validate, i) for i in range(len(valid_steps))])

    def check(metrics, epoch, idx, t_b, do_log):
        m = {k: float(v) for k, v in metrics.items()}
        if do_log:
            logger.info('train: epoch[%03d], batch[%04d/%04d], elapsed '
                        'time=%0.2fs, %s', epoch, idx, n_batches,
                        time.time() - t_b, ', '.join(
                            f'{k}: {m[k]:03.3f}' for k in ('loss',) + terms))
        if n_seeds and not math.isfinite(m['loss']):
            # JAX's watchdog writes no emergency checkpoint here: it hands
            # the stacked state to its serialiser, whose int() of the [S]
            # update count raises TypeError first (utils/saver.py:221)
            logger.error('non-finite loss %s at epoch %d batch %d; a '
                         'multi-seed run writes no emergency checkpoint',
                         m['loss'], epoch, idx)
            raise FloatingPointError(f"non-finite loss {m['loss']} at "
                                     f'epoch {epoch} batch {idx}')
        state = unstack_state(stacked, 0)
        _check_finite(m['loss'], saver, state.model, state, generators(0),
                      logger, epoch, idx)

    trace = _start_trace(device)
    for epoch in range(start_epoch, params['epoch']):
        t0 = time.time()
        outs, weights = [], None
        if run_chunk is None:
            for idx, batch in enumerate(train_loader):
                t_b = time.time()
                metrics = train_step(
                    _device_batch(batch, device, keys, train_bank),
                    *train_gens)
                outs.append(metrics)
                do_log = log_iv != -1 and idx % log_iv == 0
                if do_log or idx % check_iv == 0:
                    check(metrics, epoch, idx, t_b, do_log)
        else:
            weights, idx, t_b = [], 0, time.time()
            for pending in _chunks(train_loader, chunk):
                n = len(pending)
                metrics = run_chunk(pending, *train_gens)
                outs.append(metrics)
                weights.append(n)
                iv = max(log_iv, 1)
                do_log = log_iv != -1 and idx // iv != (idx + n) // iv
                # idx == 0: a non-finite first step shows at the first
                # chunk, as at the per-step path's first check
                if do_log or idx == 0 or \
                        idx // check_iv != (idx + n) // check_iv:
                    check(metrics, epoch, idx, t_b, do_log)
                idx += n
                t_b = time.time()
        fetched = _fetch(outs)
        avg_loss = _avg(fetched, 'loss', weights)
        epoch_secs = time.time() - t0
        logger.info('epoch [%03d]: elapsed time:%0.2fs, avg loss: %03.3f, '
                    'miou: %03.3f', epoch, epoch_secs, avg_loss,
                    _avg(fetched, 'miou', weights))
        saver.log_metrics({'epoch': epoch, 'phase': 'train',
                           'seconds': epoch_secs, 'loss': avg_loss,
                           **{k: _avg(fetched, k, weights) for k in terms}})
        if (epoch + 1) % params['test_interval'] == 0 or epoch == 0:
            statistics['loss'][epoch] = round(avg_loss, 3)
        if (epoch + 1) % params['test_interval'] == 0:
            per_seed = valid_passes(epoch, generator=valid_gen)
            miou = float(np.mean(per_seed))
            record = {'epoch': epoch, 'phase': 'valid', 'miou': miou}
            if n_seeds:
                logger.info('multi-seed valid: miou per seed %s, mean %0.4f, '
                            'std %0.4f', ['%.4f' % m for m in per_seed], miou,
                            float(np.std(per_seed)))
                record['miou_per_seed'] = per_seed
            saver.log_metrics(record)
            statistics['mIoU'][epoch] = round(miou * 100, 2)
        if ((epoch + 1) % params['save_model_interval'] == 0
                or epoch + 1 == params['epoch']):
            for i in range(n_seeds_of(stacked)):
                state = unstack_state(stacked, i)
                path = saver.model_path(epoch)
                if n_seeds:  # JAX _multiseed_save: alias_EEEEE_s{i}.ckp
                    path = path.replace('.ckp', f'_s{i}.ckp')
                logger.info('Save model in %s', saver.save_checkpoint(
                    path, state.model, state, generators(i)))
    saver.wait()  # the async writer's last checkpoint is on disk
    _stop_trace(trace, params['alias'], device)
    _print_statistics(statistics)
    return statistics


def run_valid(valid_step, loader, params, logger, epoch: int,
              saver: Optional[RunManager], device: torch.device,
              generator: torch.Generator, bank=None,
              graphed: bool = True, submit_suffix: str = '') -> float:
    """One valid pass: losses, the submit JSON (its split name followed by
    ``submit_suffix``, a multi-seed run's ``.s{i}``), the mean IoU it
    returns. The pseudo videos come from ``generator``, batch after
    batch; on a ``bank`` the pass is the banked epoch of
    :func:`_eval_epoch` in ticks of ``eval_scan_group`` batches
    (``graphed`` on a card)."""
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, fetched = _eval_epoch(
        valid_step, loader, bank, device, TRAIN_KEYS, generator,
        group=int(params.get('eval_scan_group', 8)), _graphed=graphed)
    for i, batch in enumerate(host_batches):
        _collect_predictions(pred_dict, batch, fetched['pred_time'][i],
                             fetched['score'][i])
    if saver is not None:
        saver.save_submits(pred_dict, epoch, 'val_data' + submit_suffix)
    miou = _avg(fetched, 'miou')
    logger.info('epoch [%03d]: elapsed time:%0.4fs, avg loss: %03.3f, '
                'miou: %03.3f avg loss_g: %03.3f, avg loss_m1: %03.3f, '
                'avg loss_m2: %03.3f', epoch, time.time() - t0,
                _avg(fetched, 'loss'), miou, _avg(fetched, 'loss_g'),
                _avg(fetched, 'loss_intra'), _avg(fetched, 'loss_inter'))
    return miou


def run_eval_collect(eval_step, loader, params, logger, epoch: int,
                     saver: Optional[RunManager], device: torch.device,
                     submit_key: str, bank=None) -> float:
    """The baseline's valid pass: the submit JSON under ``submit_key``'s
    split (``'<key>.<suffix>'`` adds ``.<suffix>`` to the file's split
    name) and the mean IoU it returns; on a ``bank``, the banked epoch of
    :func:`_eval_epoch`."""
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, fetched = _eval_epoch(
        eval_step, loader, bank, device,
        group=int(params.get('eval_scan_group', 8)))
    for i, batch in enumerate(host_batches):
        _collect_predictions(pred_dict, batch, fetched['pred_time'][i],
                             fetched['score'][i])
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


def main_test(params: Dict[str, Any], _graphed: bool = True) -> str:
    """Evaluate GMD on ``test_data``: write the submit JSON (and its
    ``.metrics.json``), print the retrieval table, return the submit path.
    ``_graphed=False`` runs a banked epoch's ticks without CUDA graphs."""
    return _test(params, 'gmd', make_gmd_test_step, _graphed)


def main_test_baseline(params: Dict[str, Any], _graphed: bool = True) -> str:
    """:func:`main_test` for the QAVE baseline."""
    return _test(params, 'baseline', make_baseline_eval_step, _graphed)


def _assembler(bank):
    return None if bank is None else bank.assemble


def _test(params: Dict[str, Any], kind: str, make_step,
          _graphed: bool = True) -> str:
    device = resolve_device(params.get('device', 'cuda'))
    if device.type == 'cuda':
        exact_bf16_products()
    pt = _PhaseTimer()
    logger = setup_logger(params['alias'])
    saver = RunManager(params)
    lg = str(params['vfeat_fn']).lower() == 'lg'

    model = _seeded_model(params, torch.device('cpu'), kind)
    pt.mark('setup')
    test_set = make_dataset(params, 'test_data', 'test_featpath', 'test')
    pt.mark('dataset')
    test_bank = maybe_device_bank(params, test_set, device, logger)
    test_loader = BatchLoader(test_set, params['batch_size'][0],
                              shuffle=False,
                              device_assemble=test_bank is not None)
    pt.mark('bank')
    if params.get('start_from'):
        model.load_state_dict(load_reference_ckp(params['start_from']))
        logger.warning('use checkpoint: %s', params['start_from'])
    model = model.to(device).eval()
    pt.mark('init')

    topk = int(params.get('eval_topk', 1) or 1)
    test_step = make_step(model, lg, _assembler(test_bank), topk=topk,
                          topk_nms_iou=float(params.get('topk_nms_iou', 0.5)))
    pred_dict = _new_pred_dict(params)
    t0 = time.time()
    host_batches, fetched = _eval_epoch(
        test_step, test_loader, test_bank, device, timer=pt,
        group=int(params.get('eval_scan_group', 8)), _graphed=_graphed)
    pt.mark('eval_loop')
    losses = [float(x) for x in fetched['loss']]
    mious = [float(x) for x in fetched['miou']]
    _log_eval_batches(logger, 'test', losses, mious,
                      params['batch_log_interval'],
                      (time.time() - t0) / max(len(host_batches), 1))
    for i, batch in enumerate(host_batches):
        _collect_predictions(
            pred_dict, batch, fetched['pred_time'][i], fetched['score'][i],
            pred_topk=fetched['pred_time_topk'][i] if topk > 1 else None,
            score_topk=fetched['score_topk'][i] if topk > 1 else None)
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
