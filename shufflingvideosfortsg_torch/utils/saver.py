"""Run management for the drivers.

Counterpart of ``RunManager`` in ``shufflingvideosfortsg_tpu/utils/saver.py``
(``:99-180``): the ``<runs>/<alias>/{model,submits}`` layout,
``params.json``, the refusal to reuse an alias unless it starts with
'test'/'inference' (the old run directory is then removed), submit names
``<alias>_<step:05d>_<split>.json``, ``metrics.jsonl`` and checkpoints.
A checkpoint is a reference ``.ckp``: the model's ``state_dict`` on the
CPU, named ``<alias>_<epoch:05d>.ckp``, which the port's and the JAX
package's drivers read with ``--start_from``. Optimizer state, async
writes and ``--start_from auto`` are not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from typing import Any, Dict

import numpy as np
import torch


class RunManager:
    def __init__(self, params: Dict[str, Any], allow_existing: bool = False):
        self.params = params
        self.root_folder = os.path.join(params['runs'], params['alias'])
        self.model_folder = os.path.join(self.root_folder, 'model')
        self.submits_folder = os.path.join(self.root_folder, 'submits')
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

    def save_checkpoint(self, step: int, model: torch.nn.Module) -> str:
        """Write ``model``'s weights as a reference ``.ckp``; atomic (a
        temporary file renamed into place). Returns the path."""
        path = self.model_path(step)
        tmp = path + '.tmp'
        torch.save({k: v.detach().cpu()
                    for k, v in model.state_dict().items()}, tmp)
        os.replace(tmp, path)
        return path

    def log_metrics(self, record: Dict[str, Any]) -> None:
        """Append one JSON line to ``<run>/metrics.jsonl``."""
        with open(os.path.join(self.root_folder, 'metrics.jsonl'), 'a') as f:
            f.write(json.dumps(_jsonable(record)) + '\n')

    def save_submits(self, submits: Dict[str, Any], step: int,
                     key: str = 'val_data') -> str:
        split = self.params[key].split('/')[-1].split('.')[0]
        file_name = os.path.join(
            self.submits_folder,
            '%s_%05d_%s.json' % (self.params['alias'], step, split))
        with open(file_name, 'w') as f:
            json.dump(_jsonable(submits), f)
        return file_name


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
