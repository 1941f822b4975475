"""The port's packed-feature reader against the JAX package's: the same
FEATPAK1 packs (``tools/make_synth_pack.py`` through
``chip_smoke.write_pack``, at T=24, D=32, f16 and f32)
read through ``shufflingvideosfortsg_torch.data.featpack`` and
``shufflingvideosfortsg_tpu.data.featpack`` give the same bytes; the
port's native gather (its own g++ build of ``native/featpack.cpp``)
equals its numpy memmap reader byte for byte."""

import ctypes
import os
import shutil

import numpy as np
import pytest

import chip_smoke
from shufflingvideosfortsg_torch import _native
from shufflingvideosfortsg_torch.data import featpack as port_fp
from shufflingvideosfortsg_tpu.data import featpack as jax_fp
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIDEOS = 13


@pytest.fixture(scope='module')
def packs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_featpack'))
    return {dt: chip_smoke.write_pack(root, dt, N_VIDEOS, 24, 32)
            for dt in ('f16', 'f32')}


ROWS = np.array([3, 0, 12, 3, 7, 1, 11], np.int64)


@pytest.mark.parametrize('dtype', ['f16', 'f32'])
@pytest.mark.parametrize('method', ['gather', 'gather_raw'])
def test_port_reader_matches_jax_reader(packs, dtype, method):
    port = port_fp.PackedFeatureSource(packs[dtype])
    ref = jax_fp.PackedFeatureSource(packs[dtype])
    assert port.native
    got = getattr(port, method)(ROWS)
    want = getattr(ref, method)(ROWS)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    ref.close()
    port.close()


@pytest.mark.parametrize('dtype', ['f16', 'f32'])
@pytest.mark.parametrize('method', ['gather', 'gather_raw'])
def test_native_gather_matches_memmap_bytes(packs, dtype, method):
    native = port_fp.PackedFeatureSource(packs[dtype])
    plain = port_fp.PackedFeatureSource(packs[dtype], use_native=False)
    assert native.native and not plain.native
    rows = np.arange(N_VIDEOS)[::-1]
    got = getattr(native, method)(rows)
    want = getattr(plain, method)(rows)
    assert got.dtype == want.dtype == (
        np.float32 if method == 'gather' else native.raw_dtype)
    assert got.tobytes() == want.tobytes()
    # into a caller's buffer
    out = np.full_like(want, 7)
    assert getattr(native, method)(rows, out=out) is out
    assert out.tobytes() == want.tobytes()
    native.close()


@pytest.mark.parametrize('dtype', ['f16', 'f32'])
def test_port_reader_metadata_matches_jax(packs, dtype):
    port = port_fp.PackedFeatureSource(packs[dtype])
    ref = jax_fp.PackedFeatureSource(packs[dtype], use_native=False)
    assert (port.T, port.D, port.num_videos, port.dtype) == \
        (ref.T, ref.D, ref.num_videos, ref.dtype)
    assert port.vid_to_row == ref.vid_to_row
    assert port.raw_dtype == ref.raw_dtype
    vids = ['V0005', 'V0000', 'V0012']
    np.testing.assert_array_equal(port.rows_for(vids), ref.rows_for(vids))
    np.testing.assert_array_equal(port.nfeats_for(ROWS),
                                  ref.nfeats_for(ROWS))
    assert port_fp.is_featpack_dir(packs[dtype])
    assert not port_fp.is_featpack_dir(os.path.dirname(packs[dtype]))
    assert (port_fp.MAGIC, port_fp.HEADER_FMT, port_fp.HEADER_SIZE) == \
        (jax_fp.MAGIC, jax_fp.HEADER_FMT, jax_fp.HEADER_SIZE)


def test_closed_pack_refuses_to_gather(packs):
    pack = port_fp.PackedFeatureSource(packs['f32'])
    pack.close()
    pack.close()  # twice is harmless
    with pytest.raises(ValueError, match='closed'):
        pack.gather(ROWS)


def test_native_library_is_the_ports_own_build():
    """The reader loads its digest-named build under the package's
    ``_build/``, never ``native/libfeatpack.so``, and builds without
    ``-march=native``."""
    path = _native.build()
    assert os.path.dirname(path) == os.path.join(
        REPO, 'shufflingvideosfortsg_torch', '_build')
    assert os.path.basename(path).startswith('libfeatpack_')
    assert '-march=native' not in _native.FLAGS
    # this toolchain links OpenMP, so the gather is parallel here
    assert _native.OPENMP in _native.flags(shutil.which('g++'))
    lib = _native.featpack_library()
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert _native.build() == path  # reused, not rebuilt


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / 'featpack.cpp'
    bad.write_text('int fp_open( { syntax error\n')
    monkeypatch.setattr(_native, 'SOURCE', str(bad))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed') as info:
        _native.build()
    assert 'error' in str(info.value)
    # its temporary output is gone
    assert not [n for n in os.listdir(_native.BUILD_DIR)
                if n.endswith('.tmp') and f'.{os.getpid()}_' in n]


def test_a_toolchain_without_openmp_builds_a_serial_reader(
        tmp_path, monkeypatch, packs):
    """A g++ that cannot link OpenMP (installed without its libgomp)
    builds the same source without ``-fopenmp``: a library of its own,
    whose serial gather equals the memmap reader."""
    fake = tmp_path / 'g++'
    fake.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                    'exit 1; done\nexec g++ "$@"\n')
    fake.chmod(0o755)
    assert _native.OPENMP not in _native.flags(str(fake))
    monkeypatch.setenv('CXX', str(fake))
    serial = _native.build()
    monkeypatch.delenv('CXX')
    assert serial != _native.build()
    assert ctypes.CDLL(serial).fp_gather_raw  # the same entry points
    monkeypatch.setattr(_native, '_library', None)
    monkeypatch.setenv('CXX', str(fake))
    got = port_fp.PackedFeatureSource(packs['f16']).gather(ROWS)
    want = port_fp.PackedFeatureSource(packs['f16'],
                                       use_native=False).gather(ROWS)
    assert got.tobytes() == want.tobytes()
