"""Build and load the port's copy of the packed-feature reader.

``native/featpack.cpp`` (mmap of a ``FEATPAK1`` pack and an OpenMP batch
gather) is compiled with ``g++ -O3 -fPIC -fopenmp -shared -std=c++17`` at
first use into ``_build/`` beside this file, as :mod:`._kernels` builds the
CUDA kernels. Where the compiler has no OpenMP runtime to link (a g++
installed without its ``libgomp``, as Ubuntu 24.04's g++ 13.3 can be),
``-fopenmp`` is left out and the same source builds with its gather on one
thread. The library's name carries a hash of the source and the flags,
and it is written under a temporary name and renamed into place, so
processes that build at once agree on one file. There is no
``-march=native``: the library runs on any x86-64 host the checkout is
copied to.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

from ._kernels import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native', 'featpack.cpp')
OPENMP = '-fopenmp'
FLAGS = ('-O3', '-fPIC', OPENMP, '-shared', '-std=c++17')

_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    'fp_open': [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)],
    'fp_meta': [_P] + [ctypes.POINTER(ctypes.c_uint32)] * 4,
    'fp_gather': [_P, _I64P, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)],
    'fp_gather_raw': [_P, _I64P, ctypes.c_int64, _P],
    'fp_close': [_P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def _tag() -> str:
    return f'{os.getpid()}_{threading.get_ident()}'


@functools.lru_cache(maxsize=None)
def flags(cxx: str) -> Tuple[str, ...]:
    """:data:`FLAGS`, less ``-fopenmp`` where ``cxx`` cannot link an
    OpenMP program."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    probe = os.path.join(BUILD_DIR, f'openmp_probe_{_tag()}')
    with open(probe + '.cpp', 'w') as f:
        f.write('int main() { return 0; }\n')
    try:
        res = subprocess.run([cxx, OPENMP, probe + '.cpp', '-o', probe],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    finally:
        for path in (probe, probe + '.cpp'):
            if os.path.exists(path):
                os.remove(path)
    return FLAGS if res.returncode == 0 else \
        tuple(f for f in FLAGS if f != OPENMP)


def build() -> str:
    """Compile the reader unless this exact build exists; its path. Raises
    with the compiler's output where ``g++`` is missing or fails."""
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError('g++ not found: the packed-feature reader is '
                           f'built from {SOURCE}')
    cxx_flags = flags(cxx)
    with open(SOURCE, 'rb') as f:
        h = hashlib.sha256(' '.join(cxx_flags).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f'libfeatpack_{h.hexdigest()[:16]}.so')
    if os.path.isfile(lib_path):
        return lib_path
    tmp = f'{lib_path}.{_tag()}.tmp'
    res = subprocess.run([cxx, *cxx_flags, '-o', tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'g++ failed on {SOURCE}:\n{res.stdout}')
    os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    return lib_path


def featpack_library() -> ctypes.CDLL:
    """The loaded reader, built at first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
    return _library
