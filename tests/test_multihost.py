"""Multi-host scale-out: remote window handoff (process + slurm-style
batch backend) and a 2-process x 4-device jax.distributed window solve."""

import os
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest


@pytest.fixture()
def stack_dirs(workdir, rng):
    """S sections on disk: meshes + neighbor matches from a known drift."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu import storage
    from feabas_tpu.aligner import save_matches_to_h5, match_name
    from feabas_tpu.common import Match
    S = 8
    mesh_dir = storage.join_paths(str(workdir), 'align', 'mesh')
    tform_dir = storage.join_paths(str(workdir), 'align', 'tform')
    match_dir = storage.join_paths(str(workdir), 'align', 'matches')
    for d in (mesh_dir, tform_dir, match_dir):
        storage.makedirs(d)
    drift = np.cumsum(rng.normal(0, 2.0, (S, 2)), axis=0)
    drift -= drift[0]
    names = [f'sec{z:04d}' for z in range(S)]
    xs, ys = np.meshgrid(np.linspace(10, 110, 5), np.linspace(10, 110, 5))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    for z, name in enumerate(names):
        m = Mesh.from_bbox((0, 0, 120, 120), cartesian=True, mesh_size=30,
                           name=name, resolution=4)
        m.save_to_h5(storage.join_paths(mesh_dir, name + '.h5'))
    for z in range(S - 1):
        delta = drift[z + 1] - drift[z]
        match = Match(pts, pts + delta, np.ones(len(pts)), 0.01)
        save_matches_to_h5(storage.join_paths(
            match_dir, match_name(names[z], names[z + 1])), match, 4)
    return mesh_dir, tform_dir, match_dir, names, drift


def _check_alignment(tform_dir, names, drift, atol=0.3):
    from feabas_tpu.mesh import Mesh
    from feabas_tpu import storage
    offs = []
    for name in names:
        m = Mesh.from_h5(storage.join_paths(tform_dir, name + '.h5'))
        d = m.vertices_w_offset('MOVING') - m.vertices_w_offset('INITIAL')
        offs.append(d.mean(axis=0))
    offs = np.asarray(offs)
    offs -= offs[0]
    err = offs - (-(drift - drift[0]))
    assert np.abs(err).max() < atol, np.abs(err).max()


def test_window_handoff_process_workers(stack_dirs, workdir):
    """Each sliding window runs in a separate spawned process; state flows
    through tform files on the shared FS (reference: aligner.py:909)."""
    mesh_dir, tform_dir, match_dir, names, drift = stack_dirs
    from feabas_tpu.aligner import Stack
    stack = Stack(mesh_dir=mesh_dir, tform_dir=tform_dir,
                  match_dir=match_dir, resolution=4)
    committed = stack.optimize_slide_window(
        window_size=3, buffer_size=1, start_loc='L', residue_len=3,
        parallel_framework='process')
    assert sorted(committed) == sorted(names)
    _check_alignment(tform_dir, names, drift)


def test_window_handoff_slurm_backend(stack_dirs, workdir, tmp_path):
    """The slurm batch backend end-to-end with a local sbatch shim: jobs
    spool to a shared dir, a scheduler-launched worker optimizes the
    window and publishes the result file."""
    mesh_dir, tform_dir, match_dir, names, drift = stack_dirs
    # sbatch shim: run the submitted script locally in the background
    shim = tmp_path / 'sbatch'
    shim.write_text('#!/bin/bash\nnohup bash "$1" >/dev/null 2>&1 &\n'
                    'echo "Submitted batch job 1"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    from feabas_tpu.aligner import Stack
    stack = Stack(mesh_dir=mesh_dir, tform_dir=tform_dir,
                  match_dir=match_dir, resolution=4)
    committed = stack.optimize_slide_window(
        window_size=4, buffer_size=1, start_loc='L', residue_len=3,
        parallel_framework='slurm',
        dispatch_settings={'sbatch_cmd': str(shim),
                           'spool_dir': str(tmp_path / 'spool'),
                           'poll_interval': 0.2,
                           'job_timeout': 300})
    assert sorted(committed) == sorted(names)
    _check_alignment(tform_dir, names, drift)


def _window_system_script(out_path, n_proc, port):
    """Child script: join the cluster, solve the seeded window, save npy."""
    return textwrap.dedent(f'''
        import sys
        import numpy as np
        from feabas_tpu.parallel.window import (initialize_multihost,
                                                multihost_window_solve)
        initialize_multihost("127.0.0.1:{port}", {n_proc}, int(sys.argv[1]))
        import jax
        assert jax.device_count() == 8, jax.device_count()
        from test_multihost import build_seeded_window
        meshes, links = build_seeded_window()
        pos, n_it, res = multihost_window_solve(meshes, links, lam_s=0.1,
                                                maxiter=200)
        if jax.process_count() == 1 or int(sys.argv[1]) == 0:
            np.save({out_path!r}, pos)
        jax.distributed.shutdown()
    ''')


def build_seeded_window(S=8):
    """Deterministic synthetic window (shared by parent and subprocesses)."""
    from feabas_tpu.mesh import Mesh
    rng = np.random.default_rng(0)
    meshes = []
    for z in range(S):
        m = Mesh.from_bbox((0, 0, 60, 60), cartesian=True, mesh_size=20,
                           uid=z, name=f'z{z}', resolution=4)
        m.set_translation((0, 0))
        meshes.append(m)
    meshes[0].locked = True
    xs, ys = np.meshgrid(np.linspace(10, 50, 3), np.linspace(10, 50, 3))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    links = []
    for z in range(S - 1):
        d = rng.normal(0, 1.0, 2)
        tid0 = meshes[z].tri_finder(pts, gear='INITIAL', extrapolate=True)
        tid1 = meshes[z + 1].tri_finder(pts + d, gear='INITIAL',
                                        extrapolate=True)
        links.append({
            'idx0': meshes[z].triangles[tid0],
            'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
            'idx1': meshes[z + 1].triangles[tid1],
            'bary1': meshes[z + 1].cart2bary(pts + d, tid1, gear='INITIAL'),
            'weight': np.ones(len(pts), np.float32),
        })
    return meshes, links


def test_multihost_2proc_matches_single_process(workdir, tmp_path):
    """2 processes x 4 virtual CPU devices solve one window over a global
    jax.distributed mesh; the result must match the single-process
    8-device solve (VERDICT round-1 done-criterion)."""
    import socket
    from feabas_tpu.parallel.window import multihost_window_solve
    # single-process reference (this pytest process has 8 CPU devices)
    meshes, links = build_seeded_window()
    ref, _, _ = multihost_window_solve(meshes, links, lam_s=0.1, maxiter=200)

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    out = tmp_path / 'mh_result.npy'
    code = _window_system_script(str(out), 2, port)
    env = dict(os.environ)
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    env['JAX_PLATFORMS'] = 'cpu'
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env['PYTHONPATH'] = os.pathsep.join(
        [repo, os.path.join(repo, 'tests')]
        + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
           if p])
    procs = [subprocess.Popen([sys.executable, '-c', code, str(i)],
                              env=env, cwd=repo) for i in range(2)]
    rcs = [p.wait(timeout=560) for p in procs]
    assert rcs == [0, 0], rcs
    got = np.load(out)
    assert got.shape == np.asarray(ref).shape
    assert np.allclose(got, np.asarray(ref), atol=1e-4), \
        np.abs(got - np.asarray(ref)).max()


def test_single_job_slurm_never_degrades_to_serial(tmp_path):
    """A single job with num_workers=1 on the slurm framework MUST still
    go through sbatch (reference force_remote: concurrent.py:33,40) — the
    local-pool serial downgrade must not capture remote frameworks."""
    import stat as _stat
    from feabas_tpu.concurrent import submit_to_workers
    marker = tmp_path / 'sbatch_ran'
    shim = tmp_path / 'sbatch'
    shim.write_text(f'#!/bin/bash\ntouch "{marker}"\n'
                    'nohup bash "$1" >/dev/null 2>&1 &\n'
                    'echo "Submitted batch job 1"\n')
    shim.chmod(shim.stat().st_mode | _stat.S_IEXEC)
    from feabas_tpu.storage import base_name
    out = list(submit_to_workers(
        base_name, [('/a/b/c.txt',)], num_workers=1,
        parallel_framework='slurm', sbatch_cmd=str(shim),
        spool_dir=str(tmp_path / 'spool'),
        poll_interval=0.2, job_timeout=120))
    assert out == ['c.txt']
    assert marker.exists(), 'sbatch was never invoked: job ran in-process'
