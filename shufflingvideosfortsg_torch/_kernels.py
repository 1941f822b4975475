"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are CUDA C++ for Hopper (``sm_90a``) with a
plain C interface. :func:`build` compiles them with ``nvcc``, one process
per source started together, and links one shared library into ``_build/``
beside this file. The library's name carries a hash of the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
:func:`library` builds at first use and loads the result with ``ctypes``.

Nothing here runs at import: the toolkit is touched only when a kernel is
launched on a CUDA tensor or :func:`build` is called, so every module
imports on a machine without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')
SOURCES = ('lstm_scan.cu', 'lstm_bwd.cu', 'scdm.cu')
HEADERS = ('common.cuh',)
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on Hopper
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
# no --use_fast_math: tanhf/expf keep the f32 results inside the stated
# tolerances; -Xptxas -v reports registers, shared memory and spills;
# --split-compile 0 (a CUDA 12 option; tried with 12.9) spreads one
# source's template instantiations over the idle cores, which halves the
# build
COMPILE_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                              '-Xptxas', '-v', '--split-compile', '0')

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'svtsg_lstm_recurrence': [_P] * 7 + [_I] * 9 + [_P],
    'svtsg_lstm_recurrence_floor': [_P] * 5 + [_I] * 6 + [_P],
    'svtsg_lstm_max_rows': [_I] * 5,
    'svtsg_lstm_active_clusters': [_I] * 6,
    'svtsg_lstm_bwd': [_P] * 10 + [_I] * 9 + [_P],
    'svtsg_lstm_bwd_floor': [_P] * 8 + [_I] * 5 + [_P],
    'svtsg_lstm_bwd_max_rows': [_I] * 5,
    'svtsg_lstm_bwd_active_clusters': [_I] * 6,
    'svtsg_lstm_weight_grad': [_P] * 3 + [_I] * 8 + [_P],
    'svtsg_lstm_weight_grad_active_clusters': [_I] * 5,
    'svtsg_scdm_attention': [_P] * 6 + [_I] * 8 + [_P],
    'svtsg_scdm_bwd': [_P] * 8 + [_I] * 10 + [_P],
    'svtsg_scdm_bwd_smem_bytes': [_I] * 4,
    'svtsg_scdm_bwd_term_check': [_P, _I, _P],
    'svtsg_scdm_smem_bytes': [_I] * 3,
    'svtsg_scdm_tanh': [_P] * 2 + [_I] * 2 + [_P],
    'svtsg_scdm_term_check': [_P] * 2 + [_I, _P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME or
    /usr/local/cuda. Raises where the toolkit is missing."""
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (shutil.which('nvcc'), os.path.join(home, 'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only where '
                       'the CUDA toolkit is installed')


def _digest() -> str:
    h = hashlib.sha256(' '.join(COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> Tuple[str, float, str]:
    """Compile and link the kernels unless this exact build exists.

    Returns (library path, build seconds, compiler output); the seconds
    are 0 when the library was already there, and the output then the one
    its build saved beside it (empty where there is none)."""
    lib_path = os.path.join(BUILD_DIR, f'libsvtsg_kernels_{_digest()}.so')
    log_path = f'{lib_path}.log'
    if os.path.isfile(lib_path):
        saved = ''
        if os.path.isfile(log_path):
            with open(log_path) as f:
                saved = f.read()
        return lib_path, 0.0, saved
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tag = f'{os.getpid()}_{threading.get_ident()}'
    jobs = []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, f'{os.path.splitext(name)[0]}_{tag}.o')
        cmd = [nvcc, *COMPILE_FLAGS, '-c', os.path.join(CSRC_DIR, name),
               '-o', obj]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, proc in jobs:  # wait for every compiler, failed or not
        out, _ = proc.communicate()
        logs.append(f'== {name}\n{out}')
        if proc.returncode:
            failed.append(name)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(logs))
        tmp = f'{lib_path}.{tag}.tmp'
        link = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
        with open(f'{log_path}.{tag}.tmp', 'w') as f:
            f.write('\n'.join(logs))
        os.replace(f'{log_path}.{tag}.tmp', log_path)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return lib_path, time.perf_counter() - t0, '\n'.join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(build()[0])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.svtsg_error_string.argtypes = [ctypes.c_int]
            lib.svtsg_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().svtsg_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
