"""Run management and checkpoints for the drivers.

Counterpart of ``shufflingvideosfortsg_tpu/utils/saver.py``: ``RunManager``
(``:99-180``: the ``<runs>/<alias>/{model,submits}`` layout,
``params.json``, the refusal to reuse an alias unless it starts with
'test'/'inference' (the old run directory is then removed), submit names
``<alias>_<step:05d>_<split>.json``, ``metrics.jsonl`` and checkpoints),
``AsyncCheckpointer`` (``:53-97``), ``latest_checkpoint`` (``:191-209``)
and ``load_checkpoint`` (``:232-249``).

A checkpoint is two files. ``<alias>_<epoch:05d>.ckp`` is a reference
``.ckp``: the model's ``state_dict`` on the CPU, which the port's and the
JAX package's drivers read with ``--start_from``. Beside it,
``<alias>_<epoch:05d>.state.pt`` (the sidecar, a name that does not end
in ``.ckp``) holds what resuming needs besides the weights: the train
state (``TrainState.state_dict``: the update count and the optimizer's
state) and the states of the driver's generators, under a format tag.
The sidecar is written first and the ``.ckp`` last, each through a
temporary file renamed into place, so a ``.ckp`` on disk means its
sidecar is whole. A ``.ckp`` without a sidecar (a reference checkpoint,
or one of ``tools/export_reference_ckp.py``) loads as weights only. The
JAX package's msgpack checkpoints are not read here: the port imports no
flax; ``tools/export_reference_ckp.py`` turns one into a reference
``.ckp``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STATE_FORMAT = 'svtsg-torch-trainstate-1'


def sidecar_path(path: str) -> str:
    """The trainer-state file beside the checkpoint ``path``."""
    stem = path[:-len('.ckp')] if path.endswith('.ckp') else path
    return stem + '.state.pt'


def _to(obj, fn):
    """``obj`` with every tensor in its dicts, lists and tuples passed
    through ``fn``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _to(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, fn) for v in obj)
    return obj


def snapshot(model: torch.nn.Module, state=None,
             generators: Optional[Dict[str, torch.Generator]] = None
             ) -> Dict[str, Any]:
    """A copy of everything a checkpoint holds, taken where it lives: the
    weights and the optimizer's tensors copied on their device, enqueued
    on the current stream (a graph replay later updates the live tensors
    in place, never these), the generators' states (host tensors).
    ``{'weights': ..., 'state': None or {...}}``."""
    def copy(t):
        return t.detach().clone()

    out = {'weights': {k: copy(v) for k, v in model.state_dict().items()},
           'state': None}
    if state is not None:
        out['state'] = {
            'format': STATE_FORMAT,
            'train_state': _to(state.state_dict(), copy),
            'generators': {k: g.get_state()
                           for k, g in (generators or {}).items()}}
    return out


def _atomic_save(obj, path: str) -> None:
    tmp = path + '.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def write_snapshot(path: str, snap: Dict[str, Any]) -> None:
    """Write a :func:`snapshot` as ``path`` and its sidecar: the sidecar
    first, the ``.ckp`` last, each atomically; every tensor on the CPU."""
    def host(t):
        return t.cpu()

    if snap['state'] is not None:
        _atomic_save(_to(snap['state'], host), sidecar_path(path))
    _atomic_save(_to(snap['weights'], host), path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, Any]], bool]:
    """(weights, trainer state or None, weights only): the ``.ckp`` as the
    port's ``state_dict`` on the CPU, and its sidecar where one exists
    (``{'format', 'train_state', 'generators'}``); the last item mirrors
    JAX's ``is_reference_format``: True where there is no sidecar."""
    from .interop import load_reference_ckp
    weights = load_reference_ckp(path)
    side = sidecar_path(path)
    if not os.path.isfile(side):
        return weights, None, True
    state = torch.load(side, map_location='cpu', weights_only=True)
    if state.get('format') != STATE_FORMAT:
        raise ValueError(f'{side}: format {state.get("format")!r}, expected '
                         f'{STATE_FORMAT!r}')
    return weights, state, False


class AsyncCheckpointer:
    """Checkpoint writes in the background, in two phases as JAX's:

    1. on the caller's thread, :func:`snapshot` copies every tensor on its
       device, enqueued on the current stream, and records an event after
       the copies;
    2. a writer thread waits on that event alone (not on the device, so
       the next chunk's work is not held up), copies the snapshot to the
       host on a stream of its own, and writes it with
       :func:`write_snapshot`.

    One save is in flight at a time: a new :meth:`save` (or :meth:`wait`)
    joins the previous writer first and raises again what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, model: torch.nn.Module, state=None,
             generators=None) -> None:
        self.wait()
        snap = snapshot(model, state, generators)
        device = next(iter(snap['weights'].values())).device
        event = None
        if device.type == 'cuda':
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))

        def write():
            try:
                if event is None:
                    write_snapshot(path, snap)
                    return
                event.synchronize()
                with torch.cuda.stream(torch.cuda.Stream(device=device)):
                    write_snapshot(path, snap)
            except BaseException as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name='svtsg-ckpt-writer')
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight (if any) is on disk; raise what
        its writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class RunManager:
    def __init__(self, params: Dict[str, Any], allow_existing: bool = False):
        self.params = params
        self.root_folder = os.path.join(params['runs'], params['alias'])
        self.model_folder = os.path.join(self.root_folder, 'model')
        self.submits_folder = os.path.join(self.root_folder, 'submits')
        self._async = (AsyncCheckpointer()
                       if params.get('async_checkpoint') else None)
        self._init_dirs(allow_existing)
        with open(os.path.join(self.root_folder, 'params.json'), 'w') as f:
            json.dump(_jsonable(params), f)

    def _init_dirs(self, allow_existing: bool = False):
        if os.path.exists(self.root_folder) and not allow_existing:
            alias = self.params['alias']
            if alias.startswith('test') or alias.startswith('inference'):
                shutil.rmtree(self.root_folder)
                print(f'warning: remove test({self.root_folder}) folder')
            else:
                print('error: alias already in use, abort')
                sys.exit(1)
        os.makedirs(self.model_folder, exist_ok=True)
        os.makedirs(self.submits_folder, exist_ok=True)

    def model_path(self, step: int) -> str:
        return os.path.join(self.model_folder,
                            '%s_%05d.ckp' % (self.params['alias'], step))

    def save_checkpoint(self, path_or_step, model: torch.nn.Module,
                        state=None, generators=None,
                        sync: bool = False) -> str:
        """Write ``model``'s weights as a reference ``.ckp`` and, with a
        ``state`` (a ``TrainState``), the sidecar with it and the
        ``generators``' states; with ``async_checkpoint`` on and not
        ``sync``, schedule the write (:class:`AsyncCheckpointer`). The
        emergency checkpoint passes ``sync=True``: the run stops right
        after. Returns the ``.ckp``'s path."""
        path = (self.model_path(path_or_step)
                if isinstance(path_or_step, int) else path_or_step)
        if self._async is not None and not sync:
            self._async.save(path, model, state, generators)
        else:
            self.wait()  # keep the order of writes behind an async one
            write_snapshot(path, snapshot(model, state, generators))
        return path

    def wait(self) -> None:
        """Drain the async writer (nothing to do without one); raise what
        it raised. The train drivers call it before they return."""
        if self._async is not None:
            self._async.wait()

    def log_metrics(self, record: Dict[str, Any]) -> None:
        """Append one JSON line to ``<run>/metrics.jsonl``."""
        with open(os.path.join(self.root_folder, 'metrics.jsonl'), 'a') as f:
            f.write(json.dumps(_jsonable(record)) + '\n')

    def save_submits(self, submits: Dict[str, Any], step: int,
                     key: str = 'val_data') -> str:
        """Write ``submits`` as ``<alias>_<step:05d>_<split>.json``, the
        split named by the file of ``params[key]``; a key
        ``'<key>.<suffix>'`` (a multi-seed run's ``val_data.s{i}``) writes
        ``<split>.<suffix>``, as JAX's does (``utils/saver.py:162``)."""
        base, _, suffix = key.partition('.')
        split = self.params[base].split('/')[-1].split('.')[0]
        if suffix:
            split = f'{split}.{suffix}'
        file_name = os.path.join(
            self.submits_folder,
            '%s_%05d_%s.json' % (self.params['alias'], step, split))
        with open(file_name, 'w') as f:
            json.dump(_jsonable(submits), f)
        return file_name


def latest_checkpoint(model_dir: str) -> Optional[Tuple[str, int]]:
    """The newest ``*_NNNNN.ckp`` in a run's model directory as (path,
    epoch), or None: what ``--start_from auto`` resumes from."""
    if not os.path.isdir(model_dir):
        return None
    best: Optional[Tuple[str, int]] = None
    for name in os.listdir(model_dir):
        if not name.endswith('.ckp'):
            continue
        tail = name[:-len('.ckp')].rsplit('_', 1)[-1]
        if not tail.isdigit():
            continue
        epoch = int(tail)
        if best is None or epoch > best[1]:
            best = (os.path.join(model_dir, name), epoch)
    return best


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
