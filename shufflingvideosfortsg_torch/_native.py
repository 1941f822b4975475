"""Build and load the port's copies of the repo's native libraries.

``native/featpack.cpp`` (mmap of a ``FEATPAK1`` pack and an OpenMP batch
gather), ``native/gateway.cpp`` (the serving gateway's micro-batching
queue) and ``native/tokenizer.cpp`` (the serving tokenizer) are compiled
with ``g++ -O3 -fPIC -shared -std=c++17`` (plus ``-fopenmp`` for the
reader, ``-pthread`` for the gateway) at first use into ``_build/`` beside
this file, as :mod:`._kernels` builds the CUDA kernels. Where the compiler
has no OpenMP runtime to link (a g++ installed without its ``libgomp``, as
Ubuntu 24.04's g++ 13.3 can be), ``-fopenmp`` is left out and the reader
builds with its gather on one thread. A library's name carries a hash of
its source and flags, and it is written under a temporary name and renamed
into place, so processes that build at once agree on one file. There is
no ``-march=native``: the libraries run on any x86-64 host the checkout is
copied to. ``native/lib*.so`` (the Makefile's builds) are never loaded.

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
from typing import Dict, Optional, Sequence, Tuple

from ._kernels import BUILD_DIR

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
SOURCE = os.path.join(NATIVE_DIR, 'featpack.cpp')
OPENMP = '-fopenmp'
FLAGS = ('-O3', '-fPIC', OPENMP, '-shared', '-std=c++17')
GATEWAY_SOURCE = os.path.join(NATIVE_DIR, 'gateway.cpp')
GATEWAY_FLAGS = ('-O3', '-fPIC', '-pthread', '-shared', '-std=c++17')
TOKENIZER_SOURCE = os.path.join(NATIVE_DIR, 'tokenizer.cpp')
TOKENIZER_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')

_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    'fp_open': [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)],
    'fp_meta': [_P] + [ctypes.POINTER(ctypes.c_uint32)] * 4,
    'fp_gather': [_P, _I64P, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)],
    'fp_gather_raw': [_P, _I64P, ctypes.c_int64, _P],
    'fp_close': [_P],
}

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
# name: (argtypes, restype), as native/gateway.cpp's C ABI declares them
_GATEWAY_SIGNATURES = {
    'gw_create': ([_I64, _I32, ctypes.POINTER(ctypes.c_void_p)],
                  ctypes.c_int),
    'gw_submit': ([_P, _I32P, _I32, _I32], _I64),
    'gw_next_batch': ([_P, _I32, _I64, _I64, _I64P, _I32P, _I32P], _I32),
    'gw_complete': ([_P, _I64P, _I32, _F32P, _F32P, _F32P], ctypes.c_int),
    'gw_wait': ([_P, _I64, _I64, _F32P, _F32P, _F32P], ctypes.c_int),
    'gw_stats': ([_P, _U64P, _U64P, _U64P, _U64P], ctypes.c_int),
    'gw_shutdown': ([_P], ctypes.c_int),
    'gw_destroy': ([_P], ctypes.c_int),
}
_TOKENIZER_SIGNATURES = {
    'tok_create': ([ctypes.POINTER(ctypes.c_void_p)], ctypes.c_int),
    'tok_load_vocab': ([_P, ctypes.c_char_p, _I64P, _I32P, _I64],
                       ctypes.c_int),
    'tok_encode': ([_P, ctypes.c_char_p, _I32, _I32P, _I64], _I64),
    'tok_encode_batch': ([_P, ctypes.c_char_p, _I64P, _I64, _I32, _I32P,
                          _I64, _I32P], ctypes.c_int),
    'tok_vocab_size': ([_P], _I64),
    'tok_destroy': ([_P], ctypes.c_int),
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
_libraries: Dict[str, ctypes.CDLL] = {}


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


def _compiler() -> str:
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError('g++ not found: the port builds its native '
                           f'libraries from {NATIVE_DIR}')
    return cxx


def build_library(name: str, source: str, cxx: str,
                  cxx_flags: Sequence[str]) -> str:
    """Compile ``source`` into ``_build/lib<name>_<digest>.so`` unless that
    exact build exists; its path. Raises with g++'s output on failure."""
    with open(source, 'rb') as f:
        h = hashlib.sha256(' '.join(cxx_flags).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f'lib{name}_{h.hexdigest()[:16]}.so')
    if os.path.isfile(lib_path):
        return lib_path
    tmp = f'{lib_path}.{_tag()}.tmp'
    res = subprocess.run([cxx, *cxx_flags, '-o', tmp, source],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'g++ failed on {source}:\n{res.stdout}')
    os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    return lib_path


def build() -> str:
    """Compile the reader unless this exact build exists; its path. Raises
    with the compiler's output where ``g++`` is missing or fails."""
    cxx = _compiler()
    return build_library('featpack', SOURCE, cxx, flags(cxx))


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


def _load(name: str, source: str, cxx_flags: Sequence[str],
          signatures) -> ctypes.CDLL:
    with _lock:
        if name not in _libraries:
            lib = ctypes.CDLL(build_library(name, source, _compiler(),
                                            cxx_flags))
            for fn_name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libraries[name] = lib
    return _libraries[name]


def gateway_library() -> ctypes.CDLL:
    """The loaded micro-batching queue, built at first use."""
    return _load('gateway', GATEWAY_SOURCE, GATEWAY_FLAGS,
                 _GATEWAY_SIGNATURES)


def tokenizer_library() -> ctypes.CDLL:
    """The loaded tokenizer, built at first use."""
    return _load('tokenizer', TOKENIZER_SOURCE, TOKENIZER_FLAGS,
                 _TOKENIZER_SIGNATURES)
