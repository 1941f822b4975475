"""Device-resident feature bank: gather batches on the card, not the host.

The port's own copy of ``shufflingvideosfortsg_tpu/data/device_bank.py``.
The whole ``FEATPAK1`` pack (and the GloVe embedding matrix) goes into
device memory once; a batch then ships only O(B) integers (pack rows,
token ids, framestamps, clip counts) and :func:`assemble` builds the
features, the word embeddings and the five masks on the device.

Three tiers (``device_bank_dtype``):

- ``raw``: the pack's own dtype (f32 or f16);
- ``bf16``: f32 packs stored as bf16, half the bytes, rounded to nearest
  even chunk by chunk (an f16 pack stays f16: bf16 would only drop
  mantissa bits);
- ``int8``: symmetric per-(video, frame) quantisation with f32 scales
  (:func:`_quant_chunk`, the JAX function as it is, so the bytes agree).

The port's kernels take f32 only, so :func:`assemble` widens every tier's
gathered rows to f32 (bf16 and f16 exactly; int8 times its scales).

The upload goes chunk by chunk (64 MiB) through one pinned staging buffer
straight into one preallocated tensor: the device holds the bank and
nothing beside it, and the host at most one chunk, never a converted copy
of the whole pack.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.augment_device import device_masks
from .featpack import HEADER_SIZE

# batch keys the assembler makes on the device; an index-only loader drops
# them from the host batch (collated but never shipped)
ASSEMBLED_KEYS = ('video_feat', 'sent_feat', 'sent_mask', 'video_mask',
                  'temporal_labels', 'fore_masks', 'back_masks')
# the index keys an index-only batch ships
INDEX_KEYS = ('pack_row', 'token_ids', 'sent_len', 'framestps', 'nfeats',
              'timestps', 'duration')

# keys under which the resident tensors ride in an attached batch
BANK_FEATS = 'bank_feats'
BANK_EMB = 'bank_emb'
BANK_SCALE = 'bank_scale'  # int8 tier only: per-(video, frame) scales
BANK_KEYS = (BANK_FEATS, BANK_EMB, BANK_SCALE)

CHUNK_BYTES = 64 << 20


def _quant_chunk(a: np.ndarray):
    """Symmetric per-(video, frame) int8 quantization of [..., D] features.

    scale = rowwise amax / 127 (1/127 for all-zero rows), so the dequant
    error is bounded by scale/2 = amax/254 per element — about 0.4% of the
    frame's dynamic range, below bf16's 2^-8 relative step for the row's
    largest values. Returns (int8 values, f32 scales[...])."""
    a = np.asarray(a, np.float32)
    amax = np.max(np.abs(a), axis=-1)
    scale = (np.where(amax > 0, amax, 1.0) / 127.0).astype(np.float32)
    q = np.clip(np.rint(a / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


class _Uploader:
    """Copies host chunks into preallocated device tensors through one
    staging buffer, pinned where the destination is a card."""

    def __init__(self, device: torch.device, chunk_bytes: int):
        self.device = device
        self.staging = torch.empty(chunk_bytes, dtype=torch.uint8,
                                   pin_memory=device.type == 'cuda')

    def put(self, dst: torch.Tensor, at: int, chunk: torch.Tensor) -> None:
        """dst[at:at + len(chunk)] = chunk (a CPU tensor of dst's dtype)."""
        n = chunk.numel() * chunk.element_size()
        if n > self.staging.numel():
            raise ValueError(f'chunk of {n} bytes > staging buffer')
        stage = self.staging[:n].view(chunk.dtype).view(chunk.shape)
        stage.copy_(chunk)
        dst[at:at + chunk.shape[0]].copy_(stage, non_blocking=True)
        if self.device.type == 'cuda':
            # the staging buffer is refilled next: wait for this copy
            torch.cuda.current_stream(self.device).synchronize()


def _rows_a_chunk(shape, itemsize: int, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(1, int(np.prod(shape[1:])) * itemsize))


def _upload(host: np.ndarray, device: torch.device, chunk_bytes: int,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``host`` as one tensor on ``device``, converted chunk by chunk to
    ``dtype`` (by ``torch.Tensor.to``: round to nearest even for bf16)."""
    src_dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
    dtype = src_dtype if dtype is None else dtype
    out = torch.empty(host.shape, dtype=dtype, device=device)
    rows = _rows_a_chunk(host.shape, max(dtype.itemsize, src_dtype.itemsize),
                         chunk_bytes)
    up = _Uploader(device, rows * max(1, int(np.prod(host.shape[1:])))
                   * dtype.itemsize)
    for i in range(0, host.shape[0], rows):
        chunk = torch.from_numpy(np.array(host[i:i + rows]))  # a host copy
        up.put(out, i, chunk.to(dtype))
    return out


def _upload_quantized(mm: np.ndarray, device: torch.device,
                      chunk_bytes: int):
    """int8 tier: (int8 feats [V, T, D], f32 scales [V, T]) on ``device``,
    quantised chunk by chunk on the host by :func:`_quant_chunk`."""
    V, T, D = mm.shape
    q_buf = torch.empty((V, T, D), dtype=torch.int8, device=device)
    s_buf = torch.empty((V, T), dtype=torch.float32, device=device)
    # the staging buffer holds one chunk's f32 input rows
    rows = _rows_a_chunk(mm.shape, 4, chunk_bytes)
    up = _Uploader(device, rows * T * D * 4)
    for i in range(0, V, rows):
        q, s = _quant_chunk(mm[i:i + rows])
        up.put(q_buf, i, torch.from_numpy(q))
        up.put(s_buf, i, torch.from_numpy(s))
    return q_buf, s_buf


def assemble(batch: Dict[str, Any]) -> Dict[str, Any]:
    """An attached index-only batch (``pack_row``, ``token_ids``,
    ``sent_len``, ``framestps``, ``nfeats``, ... plus the bank tensors of
    :meth:`DeviceFeatureBank.attach`) -> the full model batch, on the
    bank's device, with no host synchronisation (so a CUDA graph can
    capture it). Batches without ``pack_row`` pass through untouched."""
    if 'pack_row' not in batch:
        return batch
    batch = dict(batch)
    feats = batch.pop(BANK_FEATS)
    emb = batch.pop(BANK_EMB)
    scales = batch.pop(BANK_SCALE, None)
    rows = batch.pop('pack_row').long()
    gathered = feats.index_select(0, rows)
    if gathered.dtype == torch.int8:
        gathered = gathered.float() * scales.index_select(0, rows)[..., None]
    else:
        gathered = gathered.float()  # bf16 and f16 widen exactly
    batch['video_feat'] = gathered
    token_ids = batch['token_ids'].long()
    batch['sent_feat'] = emb.index_select(0, token_ids.flatten()).view(
        *token_ids.shape, emb.shape[1])
    N = token_ids.shape[1]
    slen = batch['sent_len'].long()[:, None]
    # inclusive end, as the host's sequence_mask(N, (0, sent_len))
    batch['sent_mask'] = (torch.arange(N, device=slen.device)[None, :]
                          <= slen).to(torch.int32)
    batch.update(device_masks(batch['framestps'][:, 0],
                              batch['framestps'][:, 1], batch['nfeats'],
                              feats.shape[1]))
    return batch


class DeviceFeatureBank:
    """A feature pack and the GloVe embedding matrix resident on a device."""

    # step factories take this: a function of the attached batch alone
    assemble = staticmethod(assemble)

    def __init__(self, pack, vocab, device, chunk_bytes: int = CHUNK_BYTES,
                 dtype: str = 'raw'):
        device = torch.device(device)
        self.bin_path = pack.bin_path
        dtype = str(dtype).lower()
        mm = np.memmap(pack.bin_path, dtype=pack.raw_dtype, mode='r',
                       offset=HEADER_SIZE,
                       shape=(pack.num_videos, pack.T, pack.D))
        self.scales = None
        if dtype == 'int8':
            self.feats, self.scales = _upload_quantized(mm, device,
                                                        chunk_bytes)
        else:
            convert = None
            if dtype == 'bf16' and pack.raw_dtype != np.float16:
                convert = torch.bfloat16
            self.feats = _upload(mm, device, chunk_bytes, convert)
        emb = np.asarray(vocab.embeddings, np.float32)
        self.embeddings = _upload(emb, device, chunk_bytes)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.nbytes = sum(t.numel() * t.element_size() for t in
                          (self.feats, self.scales, self.embeddings)
                          if t is not None)

    def attach(self, device_batch: Dict[str, Any]) -> Dict[str, Any]:
        """``device_batch`` with the resident tensors added under
        ``BANK_KEYS`` (references, no copy), for :func:`assemble`."""
        out = dict(device_batch)
        out[BANK_FEATS] = self.feats
        out[BANK_EMB] = self.embeddings
        if self.scales is not None:
            out[BANK_SCALE] = self.scales
        return out

    def key(self):
        """What a captured graph depends on: the bank's shapes and dtypes."""
        return (tuple(self.feats.shape), self.feats.dtype,
                tuple(self.embeddings.shape), self.scales is None,
                self.feats.device)


_BANK_CACHE: Dict[Any, DeviceFeatureBank] = {}


def bank_nbytes(pack, dtype: str) -> int:
    """Bytes of the features a bank of ``pack`` in tier ``dtype`` keeps."""
    itemsize = pack.raw_dtype.itemsize
    scale_bytes = 0
    if dtype == 'int8':
        itemsize = 1
        scale_bytes = pack.num_videos * pack.T * 4
    elif dtype == 'bf16' and pack.raw_dtype != np.float16:
        itemsize = 2
    return pack.num_videos * pack.T * pack.D * itemsize + scale_bytes


def maybe_device_bank(params: Dict[str, Any], dataset, device,
                      logger=None) -> Optional[DeviceFeatureBank]:
    """Build (or reuse) a device bank for a dataset's feature pack when
    the configuration allows it. Returns None when:

    - ``device_bank`` is off in the config,
    - the dataset has no packed source (per-file .npy/hdf5 stores),
    - host-side augmentation needs the features on the host (``if_aug`` on
      a train set),
    - the pack with the banks already resident would pass the budget
      ``device_bank_max_gb`` (the cache never evicts, so two packs each
      under the budget could jointly overflow the card).

    Banks are cached by (pack path, tier, device index)."""
    if not params.get('device_bank', True):
        return None
    pack = getattr(dataset, 'pack', None)
    if pack is None:
        return None
    if dataset.is_train and bool(params.get('if_aug', False)):
        return None  # host aug_data mutates features before masking
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    bank_dtype = str(params.get('device_bank_dtype', 'raw')).lower()
    if bank_dtype not in ('raw', 'bf16', 'int8'):
        raise ValueError(f'device_bank_dtype {bank_dtype!r}: raw, bf16 or '
                         'int8')
    max_gb = float(params.get('device_bank_max_gb', 8.0))
    nbytes = bank_nbytes(pack, bank_dtype)
    resident = sum(b.nbytes for k, b in _BANK_CACHE.items()
                   if k[0] != pack.bin_path)
    if nbytes + resident > max_gb * 2 ** 30:
        if logger is not None:
            logger.warning('device bank disabled: pack is %.2f GiB and '
                           '%.2f GiB of banks are already resident > '
                           'device_bank_max_gb=%.1f', nbytes / 2 ** 30,
                           resident / 2 ** 30, max_gb)
        return None
    cache_key = (pack.bin_path, bank_dtype, str(device))
    bank = _BANK_CACHE.get(cache_key)
    if bank is None:
        bank = DeviceFeatureBank(pack, dataset.vocab, device,
                                 dtype=bank_dtype)
        _BANK_CACHE[cache_key] = bank
        if logger is not None:
            logger.info('device feature bank resident: %s (%.2f GiB on %s)',
                        pack.bin_path, bank.nbytes / 2 ** 30, device)
    return bank
