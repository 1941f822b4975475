"""The PyTorch port's ground rules: it imports no JAX, its CUDA entry
points never fall back to the CPU, and its kernel wrappers take their
plain versions only for CPU tensors."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import shufflingvideosfortsg_torch
from shufflingvideosfortsg_torch import _kernels
from shufflingvideosfortsg_torch.cli import main_test, parse_params
from shufflingvideosfortsg_torch.ops.lstm_scan import (lstm_recurrence,
                                                       lstm_recurrence_bwd,
                                                       lstm_recurrence_plain,
                                                       lstm_recurrence_train)
from shufflingvideosfortsg_torch.ops.scdm_fused import (
    scdm_attention_fused, scdm_attention_fused_trainable,
    scdm_attention_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(shufflingvideosfortsg_torch.__file__)
# nor the repo's tools/ (chip_smoke.py runs tools/make_synth_pack.py as a
# program, which is no import)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'shufflingvideosfortsg_tpu',
             'tools')


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix='shufflingvideosfortsg_torch.')]


def test_port_imports_no_jax_in_a_fresh_process():
    """tests/conftest.py imports jax, so the check runs in a subprocess."""
    code = (
        'import importlib, sys\n'
        f'for m in {_port_modules()!r} + ["chip_smoke"]:\n'
        '    importlib.import_module(m)\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})\n'
        'assert not bad, bad\n'
        'print("ok", len(sys.modules))\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith('ok')


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split('.')[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split('.')[0]]
            else:
                continue
            assert not set(roots) & set(FORBIDDEN), (path, node.lineno)


SERVING_MODULES = ('shufflingvideosfortsg_torch.serving',
                   'shufflingvideosfortsg_torch.gateway',
                   'shufflingvideosfortsg_torch.data.text_native',
                   'shufflingvideosfortsg_torch.profile_serve')


def test_scans_cover_the_serving_modules():
    """The two scans above walk the whole package; the serving tier is in
    what they walk."""
    assert set(SERVING_MODULES) <= set(_port_modules())
    for name in SERVING_MODULES:
        path = os.path.join(REPO, *name.split('.')) + '.py'
        assert os.path.isfile(path), path


ZOO_AND_AOT_MODULES = ('shufflingvideosfortsg_torch.utils.aot',
                       'shufflingvideosfortsg_torch.utils.batches',
                       'shufflingvideosfortsg_torch.export_serving',
                       'shufflingvideosfortsg_torch.measure_dispatch',
                       'shufflingvideosfortsg_torch.ops.rnn',
                       'shufflingvideosfortsg_torch.models.transformer',
                       'shufflingvideosfortsg_torch.models.graph',
                       'shufflingvideosfortsg_torch.models.content_predictors')


def test_scans_cover_the_aot_and_zoo_modules():
    """The AOT artifacts, their command line and the modules no config
    key reaches are in what the two scans walk."""
    assert set(ZOO_AND_AOT_MODULES) <= set(_port_modules())
    for name in ZOO_AND_AOT_MODULES:
        path = os.path.join(REPO, *name.split('.')) + '.py'
        assert os.path.isfile(path), path


def test_serving_runs_on_cuda_by_default(monkeypatch):
    """The grounder's device defaults to ``cuda`` and a missing card
    raises before any work; ``profile_serve`` measures on a card only."""
    from shufflingvideosfortsg_torch import profile_serve
    from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
    sig = inspect.signature(MultiQueryGrounder)
    assert sig.parameters['device'].default == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MultiQueryGrounder({}, {})
    with pytest.raises(SystemExit, match='needs a CUDA device'):
        profile_serve.main([])


def test_device_flag_defaults_to_cuda():
    assert parse_params([])['device'] == 'cuda'
    assert parse_params(['--device', 'cpu'])['device'] == 'cpu'


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params = parse_params(['--cfg', 'charades_cd_i3d.yml',
                           '--runs', str(tmp_path / 'runs')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main_test(params)
    assert not (tmp_path / 'runs').exists()  # raised before any work


def _k1_inputs(rng, T=5, B=3, H=8, dtype=torch.float32):
    xw = torch.from_numpy(rng.randn(T, B, 8 * H).astype(np.float32))
    w = torch.from_numpy((rng.randn(2, H, 4 * H) * 0.2).astype(np.float32))
    return xw.to(dtype), w.to(dtype)


def _k2_inputs(rng, B=2, T=6, N=5, Dh=8, Ds=4, dtype=torch.float32):
    arrays = [rng.randn(B, T, Dh), rng.randn(B, N, Dh), rng.randn(Dh),
              rng.randn(B, N, Ds)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    rng = np.random.RandomState(0)
    before = lstm_recurrence.launches, scdm_attention_fused.launches
    xw, w = _k1_inputs(rng)
    for got, want in zip(lstm_recurrence(xw, w), lstm_recurrence_plain(xw, w)):
        assert torch.equal(got, want)
    args = _k2_inputs(rng)
    assert torch.equal(scdm_attention_fused(*args), scdm_attention_plain(*args))
    # the plain version is no launch
    assert (lstm_recurrence.launches, scdm_attention_fused.launches) == before


def test_wrappers_raise_on_bf16():
    """Every flat kernel takes bf16 throughout (``precision: bf16``, held
    against JAX in tests/test_torch_bf16.py and, for training, in
    tests/test_torch_bf16_train.py): K1, K3 and K4 with xw, W_hh, out and
    d_out bf16, K2 and K5 with all their inputs bf16; each raises on bf16
    mixed with f32 and on f16."""
    rng = np.random.RandomState(1)
    xw, w = _k1_inputs(rng, dtype=torch.bfloat16)
    assert lstm_recurrence(xw, w)[0].dtype == torch.bfloat16
    args = _k2_inputs(rng, dtype=torch.bfloat16)
    assert scdm_attention_fused(*args).dtype == torch.bfloat16
    with pytest.raises(TypeError, match='float32'):
        lstm_recurrence(xw, w.float())
    with pytest.raises(TypeError, match='float32'):
        lstm_recurrence(*_k1_inputs(rng, dtype=torch.float16))
    with pytest.raises(TypeError, match='float32'):
        scdm_attention_fused(*args[:3], args[3].float())
    # the training kernels
    out, c_seq, h_T, c_T = lstm_recurrence_train(xw, w)
    assert (out.dtype, c_seq.dtype, h_T.dtype, c_T.dtype) == (
        torch.bfloat16, torch.float32, torch.float32, torch.float32)
    cot = (torch.ones_like(out), torch.ones_like(h_T), torch.ones_like(c_T))
    d_xw, d_w = lstm_recurrence_bwd(xw, w, out, c_seq, *cot)
    assert d_xw.dtype == d_w.dtype == torch.float32
    with pytest.raises(TypeError, match='float32'):
        lstm_recurrence_train(xw, w.float())
    with pytest.raises(TypeError, match='float32'):
        lstm_recurrence_train(*_k1_inputs(rng, dtype=torch.float16))
    with pytest.raises(TypeError, match='d_out'):
        lstm_recurrence_bwd(xw, w, out, c_seq, cot[0].float(), *cot[1:])
    with pytest.raises(TypeError, match='c_seq'):
        lstm_recurrence_bwd(xw, w, out, c_seq.bfloat16(), *cot)
    inputs = [a.clone().requires_grad_() for a in args]
    got = scdm_attention_fused_trainable(*inputs)
    assert got.dtype == torch.bfloat16
    grads = torch.autograd.grad(got, inputs, torch.ones_like(got))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    with pytest.raises(TypeError, match='float32'):
        scdm_attention_fused_trainable(*args[:3], args[3].float())
    with pytest.raises(TypeError, match='float32'):
        scdm_attention_fused_trainable(
            *_k2_inputs(rng, dtype=torch.float16))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; a
    'meta' tensor (neither CPU nor CUDA) must raise, not compute."""
    xw = torch.empty(4, 2, 64, device='meta')
    w = torch.empty(2, 8, 32, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        lstm_recurrence(xw, w)
    args = [torch.empty(s, device='meta')
            for s in ((2, 6, 8), (2, 5, 8), (8,), (2, 5, 4))]
    with pytest.raises(ValueError, match='CUDA'):
        scdm_attention_fused(*args)


def test_wrappers_check_shapes():
    rng = np.random.RandomState(2)
    xw, w = _k1_inputs(rng)
    with pytest.raises(ValueError, match='w_hh'):
        lstm_recurrence(xw, w[:, :4])
    vp, sp, wv, sf = _k2_inputs(rng)
    with pytest.raises(ValueError, match='disagree'):
        scdm_attention_fused(vp, sp[:, :, :4], wv, sf)


def test_missing_nvcc_raises_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _kernels.nvcc_path()


def test_kernel_build_dir_is_ignored_by_git():
    with open(os.path.join(REPO, '.gitignore')) as f:
        ignored = f.read().split()
    assert 'shufflingvideosfortsg_torch/_build/' in ignored


def test_requires_cuda_marker_is_registered(request):
    markers = ' '.join(request.config.getini('markers'))
    assert 'requires_cuda' in markers


@pytest.mark.requires_cuda
def test_requires_cuda_tests_run_only_with_a_card():
    """Skips here through the autouse fixture; on a card it runs."""
    assert torch.cuda.is_available()


def test_port_tests_run_torch_on_one_thread():
    """F3 (ROADMAP.md §3): under the Tier-1 run's six workers a torch pool
    of a thread a core made the port's tests 2.1 times slower in all, so
    every port test module runs on one thread (``tests/torch_one_thread``),
    and restores the count after it."""
    assert torch.get_num_threads() == 1
    tests = os.path.join(REPO, 'tests')
    modules = [n for n in os.listdir(tests)
               if n.startswith('test_torch_') and n.endswith('.py')]
    assert len(modules) >= 15
    for name in modules:
        with open(os.path.join(tests, name)) as f:
            assert 'from torch_one_thread import one_torch_thread' in \
                f.read(), name
