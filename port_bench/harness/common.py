"""What every cell shares: the spec files, the port's model from seeded
weights, the device bank over seeded features, and the run's context."""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import seeded, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, 'port_bench')
# the top-level names of modules no run may load: JAX and the JAX package
# (whose name the port's begins with: compared whole, never as a prefix)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'shufflingvideosfortsg_tpu')


def process_start() -> float:
    """The host clock (``time.time``) at this process's start, from
    /proc/self/stat; the module's import time where that is unreadable."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf('SC_CLK_TCK')
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden one."""
    names = list(sys.modules if modules is None else modules)
    return sorted({n for n in names if n.split('.', 1)[0] in FORBIDDEN})


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload resolved to its files: the cell, its configuration, its
    traffic mix and its correctness limits."""
    workload: Dict
    config: Dict
    mix: Dict
    limits: Dict
    per_layer: list = field(default_factory=list)
    end_to_end: list = field(default_factory=list)

    @classmethod
    def load(cls, name: str, root: str = ROOT) -> 'Cell':
        bench = load_json(root, 'BENCHMARK.json')
        wl = [w for w in bench['workloads'] if w['name'] == name]
        if not wl:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
        wl = wl[0]
        cfg = [c for c in bench['configs'] if c['name'] == wl['config']][0]
        config = load_json(root, cfg['file'])
        mix = load_json(root, 'port_bench', 'traffic', wl['traffic'] + '.json')
        limits = load_json(root, 'port_bench', 'limits', name + '.json')

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get('workloads', [name])]
        return cls(wl, config, mix, limits, mine(bench['per_layer']),
                   mine(bench['end_to_end']))


def port_params(config: Dict) -> Dict[str, Any]:
    """The port's parameters: its loader over the configuration's YAML,
    with the configuration file's ``params`` on top."""
    from shufflingvideosfortsg_torch.config import load_config
    return load_config(config['yml'], overrides=copy.deepcopy(
        config['params']))


def shapes(params: Dict) -> Dict[str, tuple]:
    """GMD's parameter names and shapes, from the port's model built on
    the meta device (no memory, no initialisation)."""
    from shufflingvideosfortsg_torch.models.build import build_model
    with torch.device('meta'):
        model = build_model(params, 'gmd', device='meta')
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def port_model(params: Dict, weights: Dict[str, torch.Tensor], device):
    """The port's GMD on ``device`` holding ``weights``."""
    from shufflingvideosfortsg_torch.models.build import build_model
    with torch.device('meta'):
        model = build_model(params, 'gmd', device='meta')
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def bank(corpus: traffic.Corpus, words: torch.Tensor, seed: int, T: int,
         D: int, device):
    """The port's ``DeviceFeatureBank`` over the seeded corpus, made on
    the device (its ``feats`` f16 [V, T, D] and ``embeddings``), without a
    pack file: the bank's own ``attach``, ``key`` and ``assemble``."""
    from shufflingvideosfortsg_torch.data.device_bank import DeviceFeatureBank
    b = DeviceFeatureBank.__new__(DeviceFeatureBank)
    b.bin_path = None
    b.scales = None
    b.feats = seeded.features(seed, corpus.nfeats, T, D, device)
    b.embeddings = words
    b.nbytes = (b.feats.numel() * b.feats.element_size()
                + words.numel() * words.element_size())
    return b


class SeededPack:
    """A pack-shaped feature source for ``MultiQueryGrounder.set_corpus``:
    ``num_videos``, ``raw_dtype``, ``vid_to_row`` and ``gather_raw``,
    whose rows are made on the device from the seed and handed over as
    host f16 arrays, as a pack's gather gives them."""

    raw_dtype = np.dtype(np.float16)

    def __init__(self, seed: int, nfeats: np.ndarray, T: int, D: int,
                 device):
        self.seed, self.nfeats, self.T, self.D = seed, nfeats, T, D
        self.device = device
        self.num_videos = len(nfeats)
        self.vid_to_row = {f'v{i}': i for i in range(self.num_videos)}

    def gather_raw(self, rows) -> np.ndarray:
        return seeded.rows_features(self.seed, self.nfeats, rows, self.T,
                                    self.D, self.device).cpu().numpy()


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    device = torch.device(device)
    if device.type != 'cuda':
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@dataclass
class Run:
    """One run's settings and what it measured."""
    seed: int
    seconds: float
    trace: bool
    device: Any
    rank: int = 0
    world: int = 1
    mesh: Any = None
    start: float = field(default_factory=process_start)
    window_start: Optional[float] = None
    window_wall: Optional[float] = None
    window_s: Optional[float] = None
    metrics: Dict[str, float] = field(default_factory=dict)
    ctx: Dict[str, Any] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0

    def open_window(self) -> float:
        """Marks the first timed step: returns ``time.perf_counter()``."""
        self.window_wall = time.time()
        self.window_start = time.perf_counter()
        return self.window_start
