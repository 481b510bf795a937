"""What the package needs to run on a GPU machine: imports that need only
numpy, scipy and JAX; the YAML subset reader; errors from the device that
propagate instead of turning into missing results; one stated matmul
precision; the compile-cache location; device work kept in one process."""

import glob
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONAL = ('cv2', 'h5py', 'yaml', 'tensorstore', 'psutil', 'matplotlib')


def test_core_path_runs_without_optional_packages():
    """With cv2, h5py, yaml, tensorstore, psutil and matplotlib blocked,
    the package imports and a tiny match, window solve and device render
    run (the path chip_smoke.py takes)."""
    code = textwrap.dedent(f'''
        import sys
        BLOCKED = {OPTIONAL!r}

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in BLOCKED:
                    raise ImportError('blocked ' + name)

        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import feabas_tpu
        from feabas_tpu import (aligner, config, matcher, optimizer,
                                renderer, stitcher, thumbnail)
        from feabas_tpu.parallel import montage, window
        import chip_smoke
        from feabas_tpu.utils.synthetic import texture
        rng = np.random.default_rng(0)
        img0 = texture(rng, 512, 384)
        img1 = np.roll(img0, (2, -3), axis=(0, 1))
        m = matcher.stitching_matcher(img0, img1, stage_prior=(3.0, -2.0),
                                      **config.stitch_configs()['matching']
                                      ['matcher_config'])
        assert m is not None and m.xy0.shape[0] > 8
        err = np.median(np.linalg.norm(m.xy0 - (m.xy1 + (3.0, -2.0)),
                                       axis=-1))
        assert err < 0.1, err
        rep = chip_smoke.Report()
        chip_smoke.phase_window(rep, 0, S=3, mesh_size=100, extent=800)
        chip_smoke.phase_render(rep, 0, size=512, block=256, n_blocks=1,
                                mesh_size=100)
        rep.close()
        assert not rep.failures, rep.failures
        loaded = [n for n in BLOCKED if n in sys.modules]
        assert not loaded, loaded
        print('OK')
    ''')
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, cwd=REPO)
    assert p.returncode == 0 and 'OK' in p.stdout, p.stderr[-3000:]


# ------------------------------------------------------------ YAML subset

@pytest.mark.parametrize('path', sorted(glob.glob(
    os.path.join(REPO, 'configs', '*.yaml'))),
    ids=lambda p: os.path.basename(p))
def test_yaml_subset_matches_pyyaml(path):
    yaml = pytest.importorskip('yaml')
    from feabas_tpu.utils import yaml_subset
    with open(path) as f:
        text = f.read()
    ours = yaml_subset.loads(text)
    assert ours == yaml.safe_load(text)
    # and what we write, PyYAML and we read back the same
    dumped = yaml_subset.dumps(ours)
    assert yaml_subset.loads(dumped) == ours
    assert yaml.safe_load(dumped) == ours


def test_yaml_save_load_round_trip(tmp_path):
    from feabas_tpu import storage
    data = {'working_directory': str(tmp_path / 'w d'), 'k': 3,
            'f': 1e-7, 'neg': -2, 'flag': False, 'none': None,
            'opts': ['#SBATCH -t 10', "it's", 'a: b', ''],
            'nested': {'list': [1, 2.5, [3, 4]], 'empty': {}, 'e': [],
                       'yes_str': 'yes', 'num_str': '12', 'inf': math.inf},
            'np': np.float32(0.25)}
    p = str(tmp_path / 'c.yaml')
    storage.save_yaml(p, data)
    back = storage.load_yaml(p)
    data['np'] = 0.25
    assert back == data


@pytest.mark.parametrize('text', [
    'a: &x 1\nb: *x\n',          # anchors and aliases
    'a: !!str 1\n',              # tags
    'a: |\n  text\n',            # block scalars
    '---\na: 1\n',               # document markers
    'a:\n  - b: 1\n',            # mappings inside sequences
    'a: 1\n  b: 2\n',            # bad indentation
    'a: 1\na: 2\n',              # duplicate keys
    'a: [1, 2\n',                # unbalanced flow list
    'a: 0755\n',                 # octal integer
])
def test_yaml_subset_rejects_the_rest(text):
    from feabas_tpu.utils import yaml_subset
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


# ------------------------------------------------- errors that propagate

def test_match_pairs_batched_raises_on_device_error(monkeypatch):
    from feabas_tpu import matcher
    from feabas_tpu.utils.synthetic import texture
    rng = np.random.default_rng(1)
    img0 = texture(rng, 512, 384)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))

    def boom(preps):
        raise RuntimeError('device out of memory')

    monkeypatch.setattr(matcher, '_fused_execute_batch', boom)
    with pytest.raises(RuntimeError, match='out of memory'):
        matcher.match_pairs_batched(
            [(img0, img1, {'stage_prior': (3.0, -2.0)})])


def test_match_pairs_batched_raises_on_prep_error(monkeypatch):
    from feabas_tpu import matcher
    real = matcher.stitching_matcher

    def prep_fails(img0, img1, **kw):
        if kw.get('fused_prep_only'):
            raise ValueError('bad prep')
        return real(img0, img1, **kw)

    monkeypatch.setattr(matcher, 'stitching_matcher', prep_fails)
    img = np.zeros((512, 384), np.uint8)
    with pytest.raises(ValueError, match='bad prep'):
        matcher.match_pairs_batched([(img, img, {'stage_prior': (0, 0)})])


def test_link_profile_raises_when_probe_fails(monkeypatch):
    from feabas_tpu.ops import link_probe

    def boom():
        raise RuntimeError('backend unavailable')

    monkeypatch.setattr(link_probe, '_measure', boom)
    link_probe.set_profile_for_testing(None)
    try:
        with pytest.raises(RuntimeError, match='backend unavailable'):
            link_probe.link_profile()
    finally:
        link_probe.set_profile_for_testing(None)


# -------------------------------------------------------------- precision

def _dot_precisions(jaxpr):
    """Precision of every dot_general in a closed jaxpr, sub-jaxprs
    (while, cond, pjit, custom rules) included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == 'dot_general':
                out.append(eqn.params['precision'])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _fem_case(name):
    import jax
    import jax.numpy as jnp
    from feabas_tpu.ops import fem
    rng = np.random.default_rng(0)
    tri = jnp.asarray(rng.uniform(0, 10, (5, 3, 2)), jnp.float32)
    B, area2 = fem.shape_matrices(tri)
    mult = jnp.ones(5, jnp.float32)
    pois = jnp.full(5, 0.3, jnp.float32)
    uv = jnp.asarray(rng.normal(0, 0.01, (5, 6)), jnp.float32)
    fns = {
        'eng_element_stiffness': lambda: jax.make_jaxpr(
            fem.eng_element_stiffness)(B, area2, mult, pois),
        'svk_element': lambda: jax.make_jaxpr(fem.svk_element)(
            B, area2, uv, mult, pois),
        'nhk_element': lambda: jax.make_jaxpr(fem.nhk_element)(
            B, area2, uv, mult),
    }
    return fns[name]()


def _stack_solve_jaxpr():
    import jax
    import jax.numpy as jnp
    import chip_smoke
    from feabas_tpu.parallel.window import stack_solve
    sys.path.insert(0, REPO)
    _, system, _ = chip_smoke.build_window(np.random.default_rng(0), 3, 100,
                                           extent=600)
    args = chip_smoke.window_args(system, jnp.asarray)
    return jax.make_jaxpr(lambda *a: stack_solve(
        *a, lam_s=0.1, maxiter=50, grid_shape=system['grid_shape'],
        sten=jnp.asarray(system['sten'])))(*args)


@pytest.mark.parametrize('name', ['stack_solve', 'eng_element_stiffness',
                                  'svk_element', 'nhk_element'])
def test_contractions_use_the_stated_precision(name):
    import jax
    from feabas_tpu.constant import MATMUL_PRECISION
    sys.path.insert(0, REPO)
    jaxpr = (_stack_solve_jaxpr() if name == 'stack_solve'
             else _fem_case(name))
    precs = _dot_precisions(jaxpr)
    assert precs, 'no contraction found'
    want = jax.lax.Precision(MATMUL_PRECISION)
    assert all(p == (want, want) for p in precs), precs


# ------------------------------------------------------------ entry points

def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax
    from feabas_tpu import config
    calls = []
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    monkeypatch.setattr(jax.config, 'update',
                        lambda k, v: calls.append((k, v)))
    path = config.enable_compile_cache()
    assert path == os.path.join(REPO, '.jax_cache')
    assert calls == [('jax_compilation_cache_dir', path)]


def test_compile_cache_leaves_a_set_variable_to_jax(monkeypatch, tmp_path):
    import jax
    from feabas_tpu import config
    calls = []
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(jax.config, 'update',
                        lambda k, v: calls.append((k, v)))
    assert config.enable_compile_cache() is None
    assert calls == []


@pytest.mark.parametrize('framework,expected', [
    ('process', 'thread'), ('thread', 'thread'), ('serial', 'serial'),
    ('slurm', 'slurm')])
def test_device_work_stays_in_one_process(framework, expected):
    from feabas_tpu.concurrent import device_framework
    assert device_framework(framework) == expected


@pytest.mark.parametrize('scale', [0.5, 0.25, 0.3, 0.7])
def test_area_resize_matches_opencv(scale):
    cv2 = pytest.importorskip('cv2')
    from feabas_tpu.common import area_resize
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (101, 203)).astype(np.uint8)
    got = area_resize(img, scale)
    want = cv2.resize(img, None, fx=scale, fy=scale,
                      interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() < 0.05


def test_area_resize_is_block_mean_at_integer_factors():
    from feabas_tpu.common import area_resize
    rng = np.random.default_rng(4)
    img = rng.normal(0, 1, (64, 96)).astype(np.float32)
    got = area_resize(img, 0.25)
    want = img.reshape(16, 4, 24, 4).mean(axis=(1, 3))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_opencv_flag_names_match_opencv():
    cv2 = pytest.importorskip('cv2')
    from feabas_tpu import common
    for name in ('IMREAD_UNCHANGED', 'IMREAD_GRAYSCALE', 'INTER_NEAREST',
                 'INTER_LINEAR', 'INTER_CUBIC', 'INTER_AREA',
                 'INTER_LANCZOS4', 'BORDER_CONSTANT', 'BORDER_REPLICATE',
                 'BORDER_REFLECT'):
        assert getattr(common, name) == getattr(cv2, name), name
