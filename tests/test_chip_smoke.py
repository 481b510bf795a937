"""chip_smoke.py's phases at toy size on the CPU backend: the same code
paths and comparisons the GPU run makes, so a broken phase shows here
before it costs a run on the card."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture()
def report():
    import chip_smoke
    rep = chip_smoke.Report()
    yield rep
    rep.close()
    assert rep.failures == []


def test_stitch_phase(report, workdir):
    import chip_smoke
    out = chip_smoke.phase_stitch(report, 0, tile_h=600, tile_w=800,
                                  overlap=300, block=512)
    assert out['residual_median_px'] <= 0.1


def test_xcorr_phase_with_trace(report, tmp_path):
    import chip_smoke
    out = chip_smoke.phase_xcorr(report, 0, n=32, chunk=16,
                                 trace_dir=str(tmp_path / 'trace'))
    assert out['subpixel_median_px'] <= 0.1
    # the trace reduction finds the DoG kernels inside the step
    assert 0 < out['dog_device_ms'] < out['step_device_ms']


def test_window_phase(report):
    import chip_smoke
    out = chip_smoke.phase_window(report, 0, S=4, mesh_size=100,
                                  extent=1000)
    assert out['max_err_px'] <= 0.1


def test_render_phase(report):
    import chip_smoke
    out = chip_smoke.phase_render(report, 0, size=1024, block=256,
                                  n_blocks=4, mesh_size=100)
    assert out['frac_within_1lsb'] >= 0.999


@pytest.mark.parametrize('ragged', [False, True])
def test_four_card_window(report, ragged):
    """z-sharded solve on 4 virtual devices equals the one-device solve
    and recovers the drift, for lattice and ragged topologies (the ragged
    count pads to the device multiple)."""
    import jax
    import chip_smoke
    chip_smoke.four_card_window(report, 0, jax.devices()[:4],
                                S=6 if ragged else 8, mesh_size=100,
                                extent=1000, ragged=ragged)


def test_four_card_montage(report):
    import jax
    import chip_smoke
    chip_smoke.four_card_montage(report, 0, jax.devices()[:4], rows=2,
                                 cols=4, tile_h=300, tile_w=400,
                                 overlap=100, mesh_size=100)


def test_four_card_matching(report, workdir):
    import jax
    import chip_smoke
    chip_smoke.four_card_matching(report, 0, jax.devices()[:4], n_pairs=4,
                                  h=1024, w=608)


def test_collective_count_parses_sync_and_async_forms():
    import chip_smoke
    hlo = ('  %ar = f32[] all-reduce(f32[] %x), to_apply=%add\n'
           '  %cp = f32[2] collective-permute-start(f32[2] %y)\n'
           '  %cpd = f32[2] collective-permute-done(%cp)\n')
    assert chip_smoke._collectives(hlo) == {
        'all-reduce': 1, 'collective-permute': 1, 'all-gather': 0}


def test_hlo_scope_names():
    import chip_smoke
    hlo = ('  %fusion.3 = f32[4] fusion(%p), kind=kLoop, '
           'metadata={op_name="jit(step)/dog_prefilter/sub"}\n'
           '  ROOT %fft.1 = c64[4] fft(%q), '
           'metadata={op_name="jit(step)/fft"}\n')
    assert chip_smoke._hlo_names_in_scope(hlo, 'dog_prefilter') == \
        {'fusion.3'}


def test_main_refuses_cpu(capsys, monkeypatch, tmp_path):
    import chip_smoke
    # a set cache variable keeps main() from enabling the cache here
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert 'needs an NVIDIA GPU' in out.err
    assert '"ok"' not in out.out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_phases_on_gpu(report, tmp_path):
    """Every phase at reduced size, compiled for the card."""
    import chip_smoke
    chip_smoke.phase_window(report, 0, S=8, mesh_size=100, extent=1000)
    chip_smoke.phase_render(report, 0, size=2048, block=512, n_blocks=4,
                            mesh_size=150)
    chip_smoke.phase_xcorr(report, 0, n=64, chunk=32,
                           trace_dir=str(tmp_path / 'trace'))
    chip_smoke.phase_stitch(report, 0, tile_h=600, tile_w=800, overlap=300,
                            block=512)
