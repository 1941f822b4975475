"""AOT serving artifacts: ``torch.export`` programs of the grounder.

Counterpart of ``shufflingvideosfortsg_tpu/utils/aot.py``. A deployed
grounding service should not need the model's source or a trace:
:func:`export_grounder` exports the serving functions of a live
``serving.MultiQueryGrounder`` (``serving.precompute``,
``serve_features``, ``serve_tokens``, ``serve_bank`` and
``serve_bank_tokens``, JAX's ``_FNS``) with ``torch.export`` at the
grounder's fixed shapes, one program a function and device, into one
directory with the weights, the resident vocabulary and the corpus bank.
:class:`ExportedGrounder` serves from that directory alone: it imports
the kernel ops (``svtsg::lstm_recurrence``, ``svtsg::scdm_attention``,
which the programs call as nodes of their graphs) and never
``shufflingvideosfortsg_torch.models``.

The weights are the first argument of every program (a dict of the
model's ``state_dict`` tensors) and not constants of it, as in JAX
(``:43-45``): one artifact serves any checkpoint of the same
architecture, and ``weights.ckp`` is a reference ``.ckp``.

Two recorded departures from JAX (``ROADMAP.md`` §3): a program is traced
for one device, so ``platforms`` lists devices (``cpu``, ``cuda``) and the
CUDA program is exported on a machine with a card, where JAX lowers for a
TPU from a host without one; and there is no ``tpu_grounder``: the
kernels are custom ops that dispatch by device, so the program of a device
already runs its kernels. A loader whose device has no program raises; it
never runs another device's program or the plain versions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import lstm_scan, scdm_fused  # noqa: F401  (register svtsg::*)
from .batches import check_rows, in_batches
from .device import exact_bf16_products, resolve_device
from .interop import load_reference_ckp

FORMAT = 'svtsg-aot-torch-v1'
MANIFEST = 'manifest.json'
WEIGHTS = 'weights.ckp'
VOCAB = 'vocab.npy'
BANK = 'bank.npz'
PLATFORMS = ('cpu', 'cuda')


def program_file(name: str, platform: str) -> str:
    return f'{name}.{platform}.pt2'


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module, so that ``functional_call`` can
    swap the model's weights for the program's first argument."""

    def __init__(self, fn, model: torch.nn.Module):
        super().__init__()
        self.fn = fn
        self.model = model

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Program(torch.nn.Module):
    """A serving function with the weights as its first argument. The
    model sits outside this module's tree, so ``torch.export`` lifts no
    parameter of it, and ``functional_call(strict=True)`` takes every
    weight from the argument: none becomes a constant of the program."""

    def __init__(self, fn, model: torch.nn.Module):
        super().__init__()
        object.__setattr__(self, 'bound', _Bound(fn, model))

    def forward(self, weights: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self.bound, {f'model.{k}': v for k, v in weights.items()}, args,
            strict=True)


def _weights_on(state: Dict[str, torch.Tensor], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """The weights as the programs take them: by sorted key, on device."""
    return {k: state[k].detach().to(device) for k in sorted(state)}


def _to(x, device: torch.device):
    return tuple(t.to(device) for t in x) if isinstance(x, tuple) \
        else x.to(device)


def _bank_host(bank) -> Tuple[Dict[str, np.ndarray], str]:
    """``bank.npz``'s arrays and the bank's dtype: the int8 tier as its
    (values, scales) pair, a raw bank as f32 (bf16 has no numpy dtype:
    its values widen exactly and the dtype is recorded)."""
    if isinstance(bank, tuple):
        return {'bank_q': bank[0].cpu().numpy(),
                'bank_s': bank[1].cpu().numpy()}, 'int8'
    return ({'bank': bank.float().cpu().numpy()},
            str(bank.dtype).replace('torch.', ''))


def export_grounder(grounder, out_dir: str,
                    platforms: Optional[Sequence[str]] = None,
                    video_feature_dim: Optional[int] = None) -> Dict[str, Any]:
    """Export a live ``MultiQueryGrounder``'s serving functions to
    ``out_dir`` and return the manifest.

    The functions follow what is resident, as JAX's do (``:105-150``): a
    resident video (``set_video``) exports ``precompute`` and
    ``serve_features`` (and ``serve_tokens`` with a vocabulary); a
    resident bank (``set_videos``, ``set_corpus`` raw or int8) exports
    ``serve_bank`` (and ``serve_bank_tokens`` with a vocabulary), the bank
    stored in ``bank.npz``. Shapes are fixed: the grounder's
    ``query_batch``, the config's ``sent_len``, the resident T.
    ``platforms`` (default: the grounder's device) are the devices to
    trace a program for; ``cuda`` needs a card. A grounder over several
    shards raises: an artifact serves on one device."""
    from ..serving import (precompute, serve_bank, serve_bank_tokens,
                           serve_features, serve_tokens)
    if len(grounder.replicas) > 1:
        raise ValueError(
            f'export_grounder exports a one-card grounder; this one is laid '
            f'over {len(grounder.replicas)} shards (build it without '
            'mesh_shape or devices= to export)')
    rnn0, bank = grounder._resident_rnn0, grounder._resident_bank
    emb = grounder._resident_emb
    if rnn0 is None and bank is None:
        raise ValueError('set_video(...) or set_corpus(...) first: export '
                         'fixes shapes from the resident state')
    platforms = list(platforms or [grounder.device.type])
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f'platform {p!r}: one of {PLATFORMS}')
        if p == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('the CUDA program is exported on a machine '
                               'with the card: no CUDA device is available')
    params = grounder.params
    Q, N = grounder.query_batch, int(params.get('sent_len', 20))
    Dv = int(video_feature_dim or params.get('video_feature_dim', 1024))
    T = int(rnn0.shape[1] if rnn0 is not None
            else (bank[0] if isinstance(bank, tuple) else bank).shape[1])
    f32, i32 = torch.float32, torch.int32
    # name -> (function, example arguments after the weights), on the CPU
    specs = {}
    if rnn0 is not None:
        specs['precompute'] = (precompute, (torch.zeros(1, T, Dv),))
        specs['serve_features'] = (serve_features,
                                   (rnn0, torch.zeros(Q, N, 300)))
        if emb is not None:
            specs['serve_tokens'] = (serve_tokens, (
                rnn0, emb, torch.zeros(Q, N, dtype=i32)))
    num_videos = bank_dtype = None
    os.makedirs(out_dir, exist_ok=True)
    if bank is not None:
        ids = torch.zeros(Q, dtype=i32)
        specs['serve_bank'] = (serve_bank,
                               (bank, torch.zeros(Q, N, 300, dtype=f32), ids))
        if emb is not None:
            specs['serve_bank_tokens'] = (serve_bank_tokens, (
                bank, emb, torch.zeros(Q, N, dtype=i32), ids))
        arrays, bank_dtype = _bank_host(bank)
        np.savez(os.path.join(out_dir, BANK), **arrays)
        num_videos = int(next(iter(arrays.values())).shape[0])
    if emb is not None:
        np.save(os.path.join(out_dir, VOCAB), emb.cpu().numpy())

    state = grounder.model.state_dict()
    for p in platforms:
        dev = torch.device(p)
        weights = _weights_on(state, dev)
        for name, (fn, args) in specs.items():
            with torch.no_grad():
                program = torch.export.export(
                    _Program(fn, grounder.model),
                    (weights, *(_to(a, dev) for a in args)), strict=False)
            # the archive would keep the example inputs, the weights among
            # them: the programs carry no tensor
            program.example_inputs = None
            torch.export.save(program, os.path.join(out_dir,
                                                    program_file(name, p)))
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               os.path.join(out_dir, WEIGHTS))
    manifest = {
        'format': FORMAT,
        'functions': list(specs),
        'video_len': T,
        'video_feature_dim': Dv,
        'sent_len': N,
        'query_batch': Q,
        'num_videos': num_videos,
        'bank_dtype': bank_dtype,
        'platforms': platforms,
        'precision': str(params.get('precision', 'f32')),
        'torch_version': torch.__version__,
    }
    with open(os.path.join(out_dir, MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedGrounder:
    """Serving from an AOT artifact directory, without the model's source.

    Mirrors the live grounder's surface (JAX ``:208-351``): :meth:`set_video`
    (the exported block-0 precompute), :meth:`ground` (feature queries),
    :meth:`ground_tokens_video` (token ids against the bundled
    vocabulary), and on a bundled bank :meth:`ground_bank` and
    :meth:`ground_tokens`, with the live grounder's batches
    (``utils/batches.in_batches``), so results are interchangeable.

    ``device`` (default ``cuda``; a missing card raises) picks the
    program of that device; a missing program raises. The weights
    (``weights.ckp``: another checkpoint of the architecture may replace
    it), the vocabulary and the bank go to the device once."""

    def __init__(self, path: str, device: str = 'cuda'):
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get('format') != FORMAT:
            raise ValueError(f'not a svtsg torch AOT artifact: {path}')
        self.device = resolve_device(str(device))
        if self.device.type == 'cuda':
            exact_bf16_products()  # as the live grounder has it
        platform = self.device.type
        if platform not in self.manifest['platforms']:
            raise ValueError(
                f'the artifact holds no {platform} program (exported for '
                f'{self.manifest["platforms"]}): export it with that '
                'platform, on a machine with the device')
        self._calls = {}
        for name in self.manifest['functions']:
            fname = os.path.join(path, program_file(name, platform))
            if not os.path.isfile(fname):
                raise FileNotFoundError(f'the artifact lacks {fname}')
            self._calls[name] = torch.export.load(fname).module()
        self.weights = _weights_on(
            load_reference_ckp(os.path.join(path, WEIGHTS)), self.device)
        vocab = os.path.join(path, VOCAB)
        self._emb = (torch.from_numpy(np.load(vocab)).to(self.device)
                     if os.path.isfile(vocab) else None)
        self.query_batch = int(self.manifest['query_batch'])
        self._rnn0 = None
        self._bank = None
        bank_path = os.path.join(path, BANK)
        if os.path.isfile(bank_path):
            with np.load(bank_path) as z:
                if 'bank_q' in z:  # int8 tier: (values, scales)
                    self._bank = (torch.from_numpy(z['bank_q']),
                                  torch.from_numpy(z['bank_s']))
                else:
                    dt = getattr(torch, self.manifest.get('bank_dtype')
                                 or 'float32')
                    self._bank = torch.from_numpy(z['bank']).to(dt)
            self._bank = _to(self._bank, self.device)

    def _call(self, name: str, *args):
        with torch.no_grad():
            return self._calls[name](self.weights, *args)

    def _batches(self, name: str, resident, arrays):
        return in_batches(lambda *b: self._call(name, *resident, *b), arrays,
                          self.query_batch, self.device)

    def set_video(self, video_feats: np.ndarray) -> None:
        if 'precompute' not in self._calls:
            raise ValueError('artifact has no single-video tier (it was '
                             'exported from a corpus-bank-only grounder; '
                             'use ground_bank/ground_tokens, or call '
                             'set_video before export)')
        T, Dv = self.manifest['video_len'], self.manifest['video_feature_dim']
        if tuple(video_feats.shape) != (T, Dv):
            raise ValueError(f'artifact was exported for video shape '
                             f'({T}, {Dv}); got {tuple(video_feats.shape)}')
        video = torch.from_numpy(np.asarray(video_feats, np.float32)[None])
        self._rnn0 = self._call('precompute', video.to(self.device))

    def _video(self):
        if self._rnn0 is None:
            raise RuntimeError('no video set: call set_video first')
        return self._rnn0

    def _tokens(self, token_ids: np.ndarray) -> np.ndarray:
        if self._emb is None:
            raise ValueError('artifact was exported without a vocab '
                             '(set_vocab before export_grounder)')
        return check_rows(token_ids, self._emb.shape[0], 'token ids')

    def _ids(self, video_ids: np.ndarray, n_queries: int) -> np.ndarray:
        if len(video_ids) != n_queries:
            raise ValueError('one video id per query')
        n = (self._bank[0] if isinstance(self._bank, tuple)
             else self._bank).shape[0]
        return check_rows(video_ids, n, 'video ids')

    def ground(self, sent_feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Spans [Q, 2] int32 and scores [Q] of sentence features
        [Q, N, 300] against the video of :meth:`set_video`."""
        return self._batches('serve_features', (self._video(),),
                             [(sent_feats, np.float32)])

    def ground_tokens_video(self, token_ids: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        if 'serve_tokens' not in self._calls:
            raise ValueError('artifact was exported without a vocab '
                             '(set_vocab before export_grounder)')
        token_ids = self._tokens(token_ids)
        return self._batches('serve_tokens', (self._video(), self._emb),
                             [(token_ids, np.int32)])

    def ground_bank(self, sent_feats: np.ndarray, video_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Feature query i against bundled bank video ``video_ids[i]``."""
        if 'serve_bank' not in self._calls:
            raise ValueError('artifact was exported without a corpus bank '
                             '(set_corpus/set_videos before export)')
        ids = self._ids(video_ids, len(sent_feats))
        return self._batches('serve_bank', (self._bank,),
                             [(sent_feats, np.float32), (ids, np.int32)])

    def ground_tokens(self, token_ids: np.ndarray, video_ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Token-id query i against bundled bank video ``video_ids[i]``
        (the production tier)."""
        if 'serve_bank_tokens' not in self._calls:
            raise ValueError('artifact lacks the token corpus tier '
                             '(set_corpus AND set_vocab before export)')
        token_ids = self._tokens(token_ids)
        ids = self._ids(video_ids, len(token_ids))
        return self._batches('serve_bank_tokens', (self._bank, self._emb),
                             [(token_ids, np.int32), (ids, np.int32)])


def load_grounder_artifact(path: str, device: str = 'cuda'
                           ) -> ExportedGrounder:
    return ExportedGrounder(path, device=device)
