"""Test fixtures. Tests run on the CPU backend with 8 virtual devices and
x64 enabled, so sharding logic and solver math are exercised without an
accelerator. Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere;
``python -m pytest tests/ -m gpu`` on a GPU machine runs them there (that
selection skips the CPU re-exec)."""

import os
import sys

# JAX reads its platform and device count when the backend starts, which
# may already have happened in this interpreter; re-exec pytest once with
# the CPU environment. The re-exec lives in pytest_configure so global
# capture can be released first (otherwise the child writes into the dead
# capture file).


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs an NVIDIA GPU; skips on the CPU backend')
    if (os.environ.get('FEABAS_TPU_TEST_REEXEC') == '1'
            or config.option.markexpr == 'gpu'):
        return
    env = dict(os.environ)
    env['FEABAS_TPU_TEST_REEXEC'] = '1'
    env['JAX_PLATFORMS'] = 'cpu'
    env['JAX_ENABLE_X64'] = 'True'  # validate solver math in f64 on CPU
    flags = env.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:
        env['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()
    capman = config.pluginmanager.getplugin('capturemanager')
    if capman is not None:
        capman.stop_global_capturing()
    args = list(config.invocation_params.args)
    os.execve(sys.executable, [sys.executable, '-m', 'pytest'] + args, env)

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU.
    Decided here, per test, never at import: every xdist worker must
    collect the same tests."""
    if request.node.get_closest_marker('gpu') is None:
        return
    import jax
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs an NVIDIA GPU (CUDA backend)')


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """Point the config system at an isolated working directory."""
    from feabas_tpu import config, storage
    cfg_dir = tmp_path / 'configs'
    cfg_dir.mkdir()
    import shutil
    repo_cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')
    for name in os.listdir(repo_cfg):
        shutil.copy(os.path.join(repo_cfg, name), cfg_dir / name)
    storage.save_yaml(str(cfg_dir / 'general_configs.yaml'), {
        'working_directory': str(tmp_path / 'work_dir'),
        'parallel_framework': 'serial',
        'full_resolution': 4,
        'section_thickness': 30,
        'logfile_level': 'NONE',
        'archive_level': 'NONE',
        'console_level': 'WARNING',
        'cpu_budget': 2,
    })
    monkeypatch.setenv('FEABAS_TPU_CONFIG_DIR', str(cfg_dir))
    config.clear_config_caches()
    yield tmp_path / 'work_dir'
    config.clear_config_caches()


@pytest.fixture()
def rng():
    return np.random.default_rng(42)
