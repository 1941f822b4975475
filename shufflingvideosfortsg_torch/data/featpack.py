"""Packed feature store reader.

The port's own copy of ``shufflingvideosfortsg_tpu/data/featpack.py``. It
reads the FEATPAK1 packs that ``tools/featpack.py`` and
``tools/make_synth_pack.py`` write: a header, then one contiguous
``[num_videos, T, D]`` f32 or f16 blob, beside an ``index.json`` of video
rows and clip counts. Two paths:

- native (the default): ctypes over the port's build of
  ``native/featpack.cpp`` (:mod:`.._native`): mmap and an OpenMP parallel
  batch gather, f16 widened to f32 in the copy. A failed build raises;
- plain (``use_native=False``): a numpy memmap with a fancy-index gather,
  the version the tests hold the native one against.

``PackedFeatureSource.gather(rows)`` returns a [B, T, D] float32 batch,
``gather_raw(rows)`` one in the pack's stored dtype.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np

MAGIC = b'FEATPAK1'
HEADER_FMT = '<8sIIIIQ'
HEADER_SIZE = struct.calcsize(HEADER_FMT)


def is_featpack_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, 'pack.bin')) and \
        os.path.isfile(os.path.join(path, 'index.json'))


_I64P = ctypes.POINTER(ctypes.c_int64)


class PackedFeatureSource:
    def __init__(self, pack_dir: str, use_native: bool = True):
        with open(os.path.join(pack_dir, 'index.json')) as f:
            index = json.load(f)
        self.vid_to_row: Dict[str, int] = index['vids']
        self.nfeats = np.asarray(index['nfeats'], np.int32)
        self.T = int(index['t'])
        self.D = int(index['d'])
        self.dtype = index['dtype']
        self.bin_path = os.path.join(pack_dir, 'pack.bin')

        with open(self.bin_path, 'rb') as f:
            head = struct.unpack(HEADER_FMT, f.read(HEADER_SIZE))
        if head[0] != MAGIC:
            raise ValueError(f'{self.bin_path}: bad featpack magic')
        if (head[2], head[3]) != (self.T, self.D):
            raise ValueError(f'{self.bin_path}: index.json says (T, D) = '
                             f'({self.T}, {self.D}), the blob '
                             f'({head[2]}, {head[3]})')
        self.num_videos = head[1]

        self._lib = self._handle = self._mm = None
        if use_native:
            from .._native import featpack_library
            self._lib = featpack_library()
            handle = ctypes.c_void_p()
            rc = self._lib.fp_open(self.bin_path.encode(),
                                   ctypes.byref(handle))
            if rc:
                raise OSError(f'fp_open({self.bin_path!r}) returned {rc}')
            self._handle = handle
        else:
            self._mm = np.memmap(self.bin_path, dtype=self.raw_dtype,
                                 mode='r', offset=HEADER_SIZE,
                                 shape=(self.num_videos, self.T, self.D))

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def raw_dtype(self) -> np.dtype:
        return np.dtype(np.float16 if self.dtype == 'f16' else np.float32)

    def rows_for(self, vids: Sequence[str]) -> np.ndarray:
        return np.asarray([self.vid_to_row[v] for v in vids], np.int64)

    def _rows(self, rows) -> np.ndarray:
        if self._handle is None and self._mm is None:
            raise ValueError(f'{self.bin_path}: the pack is closed')
        return np.ascontiguousarray(rows, np.int64)

    def gather(self, rows: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, T, D] float32 batch of the pack's ``rows``."""
        rows = self._rows(rows)
        if out is None:
            out = np.empty((len(rows), self.T, self.D), np.float32)
        if self._handle is not None:
            self._lib.fp_gather(
                self._handle, rows.ctypes.data_as(_I64P), len(rows),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            out[:] = self._mm[rows].astype(np.float32)
        return out

    def gather_raw(self, rows: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, T, D] batch in the pack's STORED dtype (f16 stays f16, half
        the host-to-device bytes; the step widens it on the device)."""
        rows = self._rows(rows)
        if out is None:
            out = np.empty((len(rows), self.T, self.D), self.raw_dtype)
        if self._handle is not None:
            self._lib.fp_gather_raw(
                self._handle, rows.ctypes.data_as(_I64P), len(rows),
                ctypes.c_void_p(out.ctypes.data))
        else:
            out[:] = self._mm[rows]
        return out

    def nfeats_for(self, rows: np.ndarray) -> np.ndarray:
        return self.nfeats[rows]

    def close(self):
        if self._handle is not None:
            self._lib.fp_close(self._handle)
            self._handle = None
        self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
