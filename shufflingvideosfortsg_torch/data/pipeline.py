"""Input pipeline: fixed-shape NumPy batches.

The port's own copy of ``shufflingvideosfortsg_tpu/data/pipeline.py``.
It replaces the reference's torch DataLoader + collate stack
(charades.py:20-50, charades_pair_aug.py:12-58):

- ``SentenceGroundingDataset`` flattens annotations, selects the feature
  sampler by dataset/feature_type rules, and builds per-sample records;
- ``BatchLoader`` shuffles, assembles fixed-shape batches (the final partial
  batch is padded with wrap-around samples; ``n_valid`` marks the real
  count so eval drops padded rows), and optionally prefetches on a thread;
- a feature path that is a FEATPAK1 pack (``data/featpack.py``) is read
  with one parallel gather a batch (f16 packs ship as f16, widened on the
  device), or, with ``device_assemble``, not at all: the batch carries
  pack rows and token ids, and ``data/device_bank.py`` builds features,
  embeddings and masks on the device;
- host-side pseudo-video pair construction is the ``host_pair_aug=True``
  mode.

All samplers' pooled outputs are LRU-cached per video (they depend only on
the video), which removes the reference's per-__getitem__ re-pooling.
"""

from __future__ import annotations

import os
import queue
import threading
from functools import lru_cache
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .annotations import detect_split, load_sentence_samples
from .augment import DataAugmentForTSG
from .featpack import PackedFeatureSource, is_featpack_dir
from .masks import sample_masks, sequence_mask
from .samplers import (clip_framestamps, frame_to_second,
                       frame_to_second_114, lg_fixed_length, one_to_one,
                       pair_mean_pool, triple_mean_pool)
from .vocab import Vocab


class FeatureStore:
    """Per-video clip features: a directory of ``<vid>.npy`` files, or an
    HDF5 archive (the reference's charades-c3d path, charades.py:74-79,
    where features live at ``f[vid]['c3d_fc6_features']``)."""

    def __init__(self, feature_path: str, mmap: bool = True):
        self.feature_path = feature_path
        self.mmap_mode = 'r' if mmap else None
        self._h5 = None
        if os.path.isfile(feature_path) and feature_path.endswith(
                ('.hdf5', '.h5')):
            import h5py
            self._h5 = h5py.File(feature_path, 'r')

    def get(self, vid: str) -> np.ndarray:
        if self._h5 is not None:
            group = self._h5[vid]
            if hasattr(group, 'keys') and 'c3d_fc6_features' in group:
                return group['c3d_fc6_features'][:]
            return group[:]
        path = os.path.join(self.feature_path, vid + '.npy')
        return np.load(path, mmap_mode=self.mmap_mode)


class SentenceGroundingDataset:
    """Per-sentence dataset with reference-equivalent record construction."""

    def __init__(self, annotation_file: str, feature_path: str,
                 params: Dict[str, Any], dataset_name: Optional[str] = None,
                 cache_videos: int = 20000):
        self.params = params
        self.dataset_name = dataset_name or params.get('train', 'charades')
        if self.dataset_name.startswith('charades'):
            self.dataset_name = 'charades'
        elif self.dataset_name.startswith('anet'):
            self.dataset_name = 'anet'
        self.sample_len = params['video_len']
        self.sent_len = params['sent_len']
        self.feature_type = str(params['feature_type']).lower()
        self.vfeat_fname = str(params['vfeat_fn']).lower()
        self.split = detect_split(annotation_file, self.dataset_name)
        self.is_train = self.split == 'train'

        self.vocab = Vocab.load(params['wordtoix_path'],
                                params['ixtoword_path'],
                                params['word_fts_path'])
        self.samples = load_sentence_samples(
            annotation_file, self.dataset_name, self.vocab, self.sent_len)
        # a packed feature blob (tools/featpack.py) is read with one
        # parallel native gather a batch instead of a np.load a sample
        self.pack: Optional[PackedFeatureSource] = None
        self.store: Optional[FeatureStore] = None
        if os.path.isdir(feature_path) and is_featpack_dir(feature_path):
            self.pack = PackedFeatureSource(feature_path)
        else:
            if not os.path.exists(feature_path):
                raise FileNotFoundError(
                    f"feature path does not exist: {feature_path!r}. The "
                    "I3D/C3D archives are external downloads (reference "
                    "README); for smoke runs generate synthetic features "
                    "with tools/make_synth_features.py, or a pack with "
                    "tools/make_synth_pack.py.")
            self.store = FeatureStore(feature_path)

        self._sampler_rng = np.random.RandomState(params.get('seed', 123))
        self.if_aug = bool(params.get('if_aug', False))
        self.data_aug = DataAugmentForTSG(
            seed=123, aug_percentage=params.get('aug_percentage', 0.5),
            mode=params.get('aug_mode', 'gt_translate'),
            seg_len=params.get('aug_seg_len'))

        self._select_sampler()
        if self._cacheable:
            self._pooled = lru_cache(maxsize=cache_videos)(self._pool_video)
        else:
            self._pooled = self._pool_video

    # -- sampler dispatch (charades.py:100-107 / anet.py:68-80) --------------

    def _select_sampler(self):
        self._cacheable = True
        if self.dataset_name == 'charades':
            if self.vfeat_fname == 'lg':
                self._mode = 'lg'
                self._cacheable = False
            elif self.feature_type in ('lgi3d',):
                self._mode = 'triple'
            else:
                self._mode = 'pair'
        else:  # anet
            if self.feature_type == 'i3d':
                self._mode = '1to1'
            elif self.vfeat_fname == 'raw':
                self._mode = 'f2s'
                self._cacheable = False  # depends on duration only; cheap anyway
            elif self.vfeat_fname == 'lg':
                self._mode = 'lg'
                self._cacheable = False
            else:
                self._mode = '114'
                self._cacheable = False

    def _load_raw(self, vid: str) -> np.ndarray:
        feats = self.store.get(vid)
        if self.feature_type == 'lgi3d':
            feats = np.resize(feats, (-1, 1024))  # reference quirk (charades.py:162)
        return feats

    def _pool_video(self, vid: str):
        """(pooled [1, T, D], nfeats) for samplers independent of the query."""
        raw = self._load_raw(vid)
        if self._mode == 'pair':
            out, _, n = pair_mean_pool(raw, (0, 0), 0, self.sample_len)
        elif self._mode == 'triple':
            out, _, n = triple_mean_pool(raw, (0, 0), 0, self.sample_len)
        elif self._mode == '1to1':
            out, _, n = one_to_one(raw, (0, 0), 0, self.sample_len)
        else:
            raise AssertionError(self._mode)
        return out, n

    def _sample_features(self, vid: str, timestamps, duration):
        if self._mode in ('pair', 'triple', '1to1'):
            out, n = self._pooled(vid)
            return out, clip_framestamps(timestamps, self.sample_len), n
        raw = self._load_raw(vid)
        if self._mode == 'f2s':
            return frame_to_second(raw, timestamps, duration, self.sample_len)
        if self._mode == '114':
            return frame_to_second_114(raw, timestamps, duration, self.sample_len)
        if self._mode == 'lg':
            return lg_fixed_length(raw, timestamps, duration, self.sample_len,
                                   self.is_train, self._sampler_rng)
        raise AssertionError(self._mode)

    # -- record construction ---------------------------------------------------

    def __len__(self):
        return len(self.samples)

    def build_record(self, idx: int, host_pair_aug: bool = False) -> Dict[str, Any]:
        s = self.samples[idx]
        needs_host_feats = host_pair_aug or (self.is_train and self.if_aug) \
            or self.pack is None
        if self.pack is not None:
            row = self.pack.vid_to_row[s.vid]
            nfeats = int(self.pack.nfeats[row])
            framestamps = clip_framestamps(s.timestamps, self.sample_len)
            feats = self.pack.gather(np.asarray([row])) \
                if needs_host_feats else None  # [1, T, D]
        else:
            feats, framestamps, nfeats = self._sample_features(
                s.vid, s.timestamps, s.duration)
        framestamps = list(framestamps)

        if self.is_train and self.if_aug and not host_pair_aug:
            framestamps, nfeats, feats = self.data_aug.aug_data(
                framestamps, nfeats, feats)

        vm, tl, fm, bm = sample_masks(self.sample_len, framestamps, nfeats)
        rec = {
            'vid': s.vid,
            'sentence': s.sentence,
            'token_ids': s.token_ids,
            'sent_len': s.sentence_len,
            'sent_mask': sequence_mask(self.sent_len, (0, s.sentence_len)),
            'duration': float(s.duration),
            'timestps': np.asarray(s.timestamps[:2], np.float32),
            'nfeats': nfeats,
            'video_mask': vm,
            'framestps': np.asarray(framestamps, np.int32),
            'temporal_labels': tl,
            'fore_masks': fm,
            'back_masks': bm,
        }
        if feats is not None:
            rec['video_feat'] = feats[0]
        else:
            rec['pack_row'] = np.int64(self.pack.vid_to_row[s.vid])
        if host_pair_aug:
            aug_f, aug_n, aug_feats = self.data_aug.aug_data(
                framestamps, nfeats, feats)
            avm, atl, afm, abm = sample_masks(self.sample_len, aug_f, aug_n)
            rec.update({
                'pseudo_video_feat': aug_feats[0],
                'pseudo_nfeats': aug_n,
                'pseudo_video_mask': avm,
                'pseudo_framestps': np.asarray(aug_f, np.int32),
                'pseudo_temporal_labels': atl,
                'pseudo_fore_masks': afm,
                'pseudo_back_masks': abm,
                # gt_translate keeps timestamps in frame units (pair_aug.py:103)
                'pseudo_timestps': np.asarray(aug_f, np.float32),
            })
        return rec

    def frame2sec(self, framestps: np.ndarray, duration: np.ndarray,
                  nfeats: np.ndarray) -> np.ndarray:
        """Frame-index -> seconds conversion (identity except 'lg')."""
        if self.vfeat_fname == 'lg':
            return framestps / nfeats[:, None] * duration[:, None]
        return framestps


_LIST_KEYS = ('vid', 'sentence')


def collate(records: List[Dict[str, Any]], n_valid: int) -> Dict[str, Any]:
    batch: Dict[str, Any] = {'n_valid': n_valid}
    for k in records[0]:
        if k in _LIST_KEYS:
            batch[k] = [r[k] for r in records]
        else:
            arr = np.stack([np.asarray(r[k]) for r in records])
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            batch[k] = arr
    return batch


class BatchLoader:
    """Shuffling fixed-shape batcher with optional thread prefetch.

    The final partial batch is padded with wrap-around samples; ``n_valid``
    gives the true count. With ``device_assemble`` (a packed source and no
    host pair aug) a batch is index-only: the keys of
    ``data/device_bank.ASSEMBLED_KEYS`` are dropped, to be rebuilt on the
    device by ``device_bank.assemble``.

    On the data axis (JAX ``data/pipeline.py:271, 296-319``) rank
    ``process_index`` of ``process_count`` loads the stripe
    ``order[process_index::process_count]`` of the identically seeded
    global shuffle, ``batch_size`` rows a batch; a shorter stripe is
    padded with its own first samples to the longest one's length (rows
    that ``n_valid`` leaves out), so every rank runs the same number of
    batches and steps.
    """

    def __init__(self, dataset: SentenceGroundingDataset, batch_size: int,
                 shuffle: bool, seed: int = 0, host_pair_aug: bool = False,
                 prefetch: int = 2, device_assemble: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if device_assemble and (dataset.pack is None or host_pair_aug):
            raise ValueError('device_assemble needs a packed feature source '
                             'and no host pair aug')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_pair_aug = host_pair_aug
        self.prefetch = prefetch
        self.device_assemble = device_assemble
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def _per_process(self) -> int:
        return -(-len(self.dataset) // self.process_count)

    def __len__(self):
        return (self._per_process() + self.batch_size - 1) // self.batch_size

    def _order(self) -> Tuple[np.ndarray, int]:
        """(this process's sample order, its real rows before the
        stripe's padding)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.process_count == 1:
            return idx, len(idx)
        idx = idx[self.process_index::self.process_count]
        real, per = len(idx), self._per_process()
        if real == 0:
            raise ValueError(f'{self.process_count} processes for '
                             f'{len(self.dataset)} samples')
        if real < per:
            idx = np.concatenate([idx, idx[np.arange(per - real) % real]])
        return idx, real

    def _make_batch(self, chunk: np.ndarray, n_valid: int) -> Dict[str, Any]:
        if len(chunk) < self.batch_size:
            pad = np.arange(self.batch_size - len(chunk)) \
                % max(len(self.dataset), 1)
            chunk = np.concatenate([chunk, pad])
        records = [self.dataset.build_record(int(i), self.host_pair_aug)
                   for i in chunk]
        batch = collate(records, n_valid)
        if self.device_assemble and 'pack_row' in batch:
            from .device_bank import ASSEMBLED_KEYS
            for k in ASSEMBLED_KEYS:
                batch.pop(k, None)
            return batch
        if 'pack_row' in batch:
            # one parallel native gather for the whole video batch; f16
            # packs ship as f16 (half the bytes, widened on the device)
            # unless h2d_dtype asks for f32
            pack = self.dataset.pack
            rows = batch.pop('pack_row')
            if pack.dtype == 'f16' and \
                    self.dataset.params.get('h2d_dtype', 'raw') == 'raw':
                batch['video_feat'] = pack.gather_raw(rows)
            else:
                batch['video_feat'] = pack.gather(rows)
        # [B, N] ids -> [B, N, 300] GloVe rows (pad id 0 = '.' embedding,
        # exactly like the reference's word_emb_init gather)
        batch['sent_feat'] = self.dataset.vocab.embeddings[batch['token_ids']]
        return batch

    def _iter_sync(self) -> Iterator[Dict[str, Any]]:
        order, real = self._order()
        self.epoch += 1  # each new iteration is a new epoch order
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            yield self._make_batch(chunk, min(len(chunk), max(0, real - i)))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure: List[BaseException] = []

        def worker():
            try:
                for b in self._iter_sync():
                    q.put(b)
            except BaseException as e:  # re-raised on the consumer's side
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
        t.join()
        if failure:
            raise failure[0]
