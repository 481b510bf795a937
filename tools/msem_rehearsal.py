"""MultiSEM-scale dress rehearsal (round-2 VERDICT next-step #10).

Generates ONE synthetic multi-mFoV section (>= 2k tiles, hex beam
pattern, mFoV groupings, MultiSEM filename convention), then drives the
REAL ``scripts/stitch_main.py`` matching -> optimization -> rendering in
subprocesses on an 8-virtual-device CPU mesh with the device-sharded
montage solve engaged. Prints one JSON line with wall times, peak RSS,
and layout-recovery error.

Run:  python tools/msem_rehearsal.py [--tiles 2000] [--workdir DIR]
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TILE = 128
E0 = np.array([100.0, 0.0])      # beam lattice vectors (28 px x-overlap)
E1 = np.array([50.0, 88.0])      # 40 px y-overlap with diagonal neighbors


def build_section(root, min_tiles=2000, seed=3, work_dir=None):
    import cv2
    from scipy.ndimage import gaussian_filter
    from feabas_tpu.multisem import beam_coordinate_vectors
    rng = np.random.default_rng(seed)
    beams = 61
    ax = beam_coordinate_vectors(beams)               # (61, 2) axial
    beam_xy = ax[:, :1] * E0 + ax[:, 1:] * E1         # (61, 2) cartesian
    bspan = beam_xy.max(0) - beam_xy.min(0) + TILE
    # hex-packed mFoV centers with slight inter-mFoV overlap
    n_mfov = int(np.ceil(min_tiles / beams))
    cols = int(np.ceil(np.sqrt(n_mfov)))
    rows = int(np.ceil(n_mfov / cols))
    step = bspan - 40.0
    true_pos, names, mfov_of = [], [], []
    m_id = 0
    for r in range(rows):
        for c in range(cols):
            if m_id >= n_mfov:
                break
            center = np.array([c * step[0] + (r % 2) * step[0] / 2,
                               r * step[1]])
            m_jit = rng.normal(0, 3.0, 2)             # stage error per mFoV
            for b in range(beams):
                p = center + beam_xy[b] - beam_xy.min(0)
                true_pos.append(p)
                names.append(f'sec0001_{m_id + 1:03d}_{b + 1:03d}_000000.bmp')
                mfov_of.append((m_id, m_jit))
            m_id += 1
    true_pos = np.asarray(true_pos)
    true_pos -= true_pos.min(0)
    # world texture large enough for every tile
    ext = (true_pos.max(0) + TILE + 8).astype(int)
    world = gaussian_filter(rng.normal(0, 1, (ext[1], ext[0])), 2)
    world = (world / world.std() * 40 + 128).clip(0, 255).astype(np.uint8)
    tile_dir = os.path.join(root, 'tiles')
    os.makedirs(tile_dir, exist_ok=True)
    lines = ['{ROOT_DIR}\t' + tile_dir, '{RESOLUTION}\t4']
    for k, name in enumerate(names):
        x0, y0 = np.round(true_pos[k]).astype(int)
        cv2.imwrite(os.path.join(tile_dir, name),
                    world[y0:y0 + TILE, x0:x0 + TILE])
        m_id, m_jit = mfov_of[k]
        stage = np.array([x0, y0], float) + m_jit + rng.normal(0, 0.5, 2)
        lines.append(f'{name}\t{stage[0]:.2f}\t{stage[1]:.2f}\t'
                     f'{stage[0] + TILE:.2f}\t{stage[1] + TILE:.2f}')
    from feabas_tpu import storage
    if work_dir is None:
        work_dir = os.path.join(root, 'work_dir')
    coord_dir = storage.join_paths(work_dir, 'stitch', 'stitch_coord')
    storage.makedirs(coord_dir, exist_ok=True)
    with storage.File(storage.join_paths(coord_dir, 'msem0.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    # round-trip ground truth for the final check
    np.save(os.path.join(root, 'true_pos.npy'), np.round(true_pos))
    return len(names)


def write_configs(root, work_dir=None):
    from feabas_tpu import storage
    if work_dir is None:
        work_dir = os.path.join(root, 'work_dir')
    os.makedirs(os.path.join(root, 'configs'), exist_ok=True)
    with open(os.path.join(root, 'configs', 'general_configs.yaml'), 'w') as f:
        f.write(f'working_directory: {work_dir}\n'
                'parallel_framework: process\n'
                'full_resolution: 4\n')
    storage.makedirs(storage.join_paths(work_dir, 'configs'), exist_ok=True)
    with storage.File(storage.join_paths(work_dir, 'configs',
                                         'stitching_configs.yaml'), 'w') as f:
        f.write('''matching:
    num_workers: 4
    min_overlap_width: 10
    margin: 16
    num_overlaps_per_job: 256
    matcher_config:
        spacings: [24]
        conf_thresh: 0.25
        coarse_downsample: 1.0
optimization:
    msem: true
    mesh_settings:
        mesh_sizes: [64]
        border_width: 32
    translation: {}
    affine:
        use_group: true
    final_elastic: {}
rendering:
    num_workers: 2
    tile_size: [2048, 2048]
    loader_settings:
        apply_CLAHE: false
        inverse: false
    render_settings:
        blend: LINEAR
''')


def run_mode(root, mode, env):
    t0 = time.time()
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'stitch_main.py'),
         '--mode', mode], cwd=root, env=env)
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return {'mode': mode, 'rc': proc.returncode,
            'wall_s': round(time.time() - t0, 1),
            'peak_child_rss_mb': round(max(r0, r1) / 1024, 1)}


def check_layout(root, work_dir=None):
    """Solved tform vs generator ground truth (global-shift invariant).

    NOTE: the absolute layout error includes the fundamental sqrt(N)
    accumulation of per-interface match noise (~0.45 px here) into
    smooth low-rank drift over the section — a few px at 2k tiles is the
    least-squares optimum, not a solver defect. Pairwise RESIDUES are
    the solver-quality metric; both are reported."""
    true_pos = np.load(os.path.join(root, 'true_pos.npy'))
    from feabas_tpu import storage
    if work_dir is None:
        work_dir = os.path.join(root, 'work_dir')
    path = storage.join_paths(work_dir, 'stitch', 'tform', 'msem0.h5')
    sys.path.insert(0, REPO)
    from feabas_tpu.stitcher import Stitcher
    st = Stitcher.from_h5(path, load_matches=False, load_meshes=True)
    got = np.asarray([m.vertices_w_offset(1).mean(0) for m in st.meshes])
    want = true_pos + TILE / 2.0
    err = got - want
    err -= err.mean(0)
    # neighbor-relative error: immune to the global drift accumulation
    from scipy.spatial import cKDTree
    d, idx = cKDTree(want).query(want, k=2)
    rel = np.linalg.norm((got - got[idx[:, 1]])
                         - (want - want[idx[:, 1]]), axis=1)
    return (float(np.abs(err).max()),
            float(np.linalg.norm(err, axis=1).mean()),
            float(np.median(rel)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tiles', type=int, default=2000)
    ap.add_argument('--workdir', default='/tmp/msem_rehearsal')
    ap.add_argument('--gcs', action='store_true',
                    help='put the working directory on a gs:// bucket '
                         '(fake-GCS shim rooted in <workdir>/fake_gcs) so '
                         'cloud staging, exists caching, and H5 staging '
                         'run end to end (BASELINE config 5)')
    args = ap.parse_args()
    root = args.workdir
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                        + ' --xla_force_host_platform_device_count=8').strip()
    env['FEABAS_TPU_SHARD_MIN_TILES'] = '64'
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    work_dir = None
    if args.gcs:
        fake_root = os.path.join(root, 'fake_gcs')
        os.makedirs(fake_root, exist_ok=True)
        os.environ['FEABAS_TPU_FAKE_GCS_ROOT'] = fake_root
        env['FEABAS_TPU_FAKE_GCS_ROOT'] = fake_root
        from feabas_tpu import storage
        storage._gcs_client.cache_clear()
        work_dir = 'gs://msem-rehearsal/work_dir'
    n = build_section(root, min_tiles=args.tiles, work_dir=work_dir)
    write_configs(root, work_dir=work_dir)
    stages = [run_mode(root, m, env)
              for m in ('matching', 'optimization', 'rendering')]
    out = {'tiles': n, 'stages': stages, 'gcs_workdir': bool(args.gcs)}
    if all(s['rc'] == 0 for s in stages):
        max_err, mean_err, rel_med = check_layout(root, work_dir=work_dir)
        out['layout_max_err_px'] = round(max_err, 2)
        out['layout_mean_err_px'] = round(mean_err, 3)
        out['neighbor_rel_err_px'] = round(rel_med, 3)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
