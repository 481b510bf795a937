"""Align-stage dress rehearsal: a synthetic serial stack driven through
the REAL ``scripts/align_main.py`` meshing -> matching -> optimization
(hierarchical chunked path) -> rendering in subprocesses on an
8-virtual-device CPU mesh. The z-axis analog of tools/msem_rehearsal.py
(reference workload: aligner.py:538-675,1158-1230).

Sections are cumulatively drifted + smoothly warped copies of one base
texture. Recovery metrics: match accuracy vs the analytic deformation
field, rendered NEIGHBOR overlap correlation (the optimized quantity),
and drift tracking straight from the tforms (solved mean translation vs
the injected drift). Prints ONE JSON line with per-stage wall/RSS and
the metrics.

Run:  python tools/align_rehearsal.py [--sections 48] [--workdir DIR]
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

H = W = 512
AMP, PERIOD = 2.5, 220.0
PHZ = 0.12                      # z phase rate: ~0.9 px neighbor warp delta


def _warp_field(z, xy):
    """Analytic displacement of section z at points xy (x, y)."""
    dx = AMP * np.sin(2 * np.pi * xy[:, 1] / PERIOD + PHZ * z)
    dy = AMP * np.cos(2 * np.pi * xy[:, 0] / PERIOD - 0.7 * PHZ * z)
    return np.stack([dx, dy], -1) * min(z, 3)


def build_stack(root, n_sections, seed=7):
    import cv2
    from feabas_tpu import storage
    from feabas_tpu.common import imwrite
    from feabas_tpu.utils.synthetic import texture
    rng = np.random.default_rng(seed)
    base = texture(rng, H + 120, W + 120).astype(np.float32)
    drift = np.cumsum(rng.normal(0, 1.5, (n_sections, 2)), axis=0)
    drift -= drift[0]
    names = [f'sec{z:04d}' for z in range(n_sections)]
    out_root = storage.join_paths(root, 'work_dir', 'stitched_sections',
                                  'mip0')
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    for z, name in enumerate(names):
        w = _warp_field(z, pts).reshape(H, W, 2)
        mx = gx + 60 + drift[z, 0] + w[..., 0]
        my = gy + 60 + drift[z, 1] + w[..., 1]
        img = cv2.remap(base, mx.astype(np.float32), my.astype(np.float32),
                        cv2.INTER_LINEAR)
        d = storage.join_paths(out_root, name)
        imwrite(storage.join_paths(d, name + '_tr1-tc1.png'),
                img.astype(np.uint8))
        with storage.File(storage.join_paths(d, 'metadata.txt'), 'w') as f:
            f.write('{ROOT_DIR}\t' + d + '\n{RESOLUTION}\t4\n')
            f.write(f'{name}_tr1-tc1.png\t0\t0\t{W}\t{H}\n')
    np.save(os.path.join(root, 'drift.npy'), drift)
    return names, drift


def write_configs(root):
    os.makedirs(os.path.join(root, 'configs'), exist_ok=True)
    with open(os.path.join(root, 'configs', 'general_configs.yaml'),
              'w') as f:
        f.write(f'working_directory: {root}/work_dir\n'
                'parallel_framework: process\n'
                'full_resolution: 4\n')
    os.makedirs(os.path.join(root, 'work_dir', 'configs'), exist_ok=True)
    with open(os.path.join(root, 'work_dir', 'configs',
                           'alignment_configs.yaml'), 'w') as f:
        f.write('''meshing:
    mesh_size: 60
matching:
    working_mip_level: 0
    compare_distance: 2
    matcher_config:
        spacings: [100, 50]
        conf_thresh: 0.25
        sigma: 2.5
        min_boundary_distance: 20
        residue_len: 3
optimization:
    num_workers: 1
    chunk_settings:
        chunked_to_depth: 1
        default_chunk_size: 12
        junction_width: 0.2
    slide_window:
        window_size: 8
        buffer_size: 2
        start_loc: L
        residue_len: 3
rendering:
    tile_size: [512, 512]
    loader_config:
        apply_CLAHE: false
        inverse: false
''')


def run_mode(root, mode, env):
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'align_main.py'),
         '--mode', mode], cwd=root, env=env)
    # ru_maxrss over children is a CUMULATIVE high-water mark — report it
    # once at the end (per-stage attribution is not possible via rusage)
    return {'mode': mode, 'rc': proc.returncode,
            'wall_s': round(time.time() - t0, 1)}


def check_match_accuracy(root, names):
    """First-pair matches vs the analytic field: xy0 in sec0 frame equals
    xy1 + drift1 + warp1(xy1) - warp0(xy1-ish); sec0 has zero warp."""
    from feabas_tpu.aligner import read_matches_from_h5, match_name
    drift = np.load(os.path.join(root, 'drift.npy'))
    m = read_matches_from_h5(os.path.join(
        root, 'work_dir', 'align', 'matches',
        match_name(names[0], names[1])))
    want = m.xy1 + drift[1] + _warp_field(1, m.xy1) - _warp_field(0, m.xy1)
    err = np.linalg.norm(m.xy0 - want, axis=-1)
    return float(np.median(err)), int(m.xy0.shape[0])


def check_overlay(root, names):
    """Aligned-stack quality on what the solve can actually determine:
    NEIGHBOR overlap correlation (the optimized quantity), plus the
    low-frequency absolute drift vs section 0 via phase correlation —
    the part only long-range anchors / chunk meta-alignment can pin
    (reference: README:305-311). Overlay against section 0 is NOT a
    recoverable target here: the synthetic warp varies with z, so the
    elastic optimum distributes deformation between neighbors instead
    of returning every section to the base geometry."""
    from feabas_tpu.dal import StaticImageLoader
    out_root = os.path.join(root, 'work_dir', 'aligned_stack', 'mip0')
    imgs = []
    for z, n in enumerate(names):
        meta = os.path.join(out_root, f'{z:05d}_{n}', 'metadata.txt')
        if not os.path.exists(meta):
            return None, z
        ld = StaticImageLoader.from_coordinate_file(meta)
        imgs.append(ld.crop((0, 0, W, H)).astype(np.float64)[90:-90, 90:-90])
    ccs = []
    for z in range(len(imgs) - 1):
        a, b = imgs[z].ravel(), imgs[z + 1].ravel()
        ok = (a > 0) & (b > 0)
        ccs.append(float(np.corrcoef(a[ok], b[ok])[0, 1]))

    return float(np.median(ccs)), len(imgs)


def check_drift_tracking(root, names):
    """Ground-truth drift recovery straight from the tforms: each solved
    mean translation must equal the injected +drift[z] (content sampled
    at p + drift renders aligned when the mesh moves by +drift); the
    max deviation relative to section 0 is the stack's absolute drift
    error — the quantity long-range anchors exist to bound."""
    from feabas_tpu.mesh import Mesh
    drift = np.load(os.path.join(root, 'drift.npy'))
    errs = []
    for z, n in enumerate(names):
        mt = Mesh.from_h5(os.path.join(root, 'work_dir', 'align', 'tform',
                                       n + '.h5'))
        mo = Mesh.from_h5(os.path.join(root, 'work_dir', 'align', 'mesh',
                                       n + '.h5'))
        t = (mt.vertices_w_offset(1).mean(0)
             - mo.vertices_w_offset(-1).mean(0))
        errs.append(t - drift[z])
    errs = np.asarray(errs) - errs[0]
    return float(np.abs(errs).max())


def residue_p90(root):
    path = os.path.join(root, 'work_dir', 'align', 'residues.csv')
    if not os.path.exists(path):
        return None
    vals = []
    with open(path) as f:
        next(f, None)  # header: sec0,sec1,num_matches,median,p90,max
        for line in f:
            parts = line.strip().split(',')
            if len(parts) >= 6:
                try:
                    vals.append(float(parts[4]))
                except ValueError:
                    continue
    # the worst per-pair p90 across the stack
    return None if not vals else float(np.max(vals))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--sections', type=int, default=48)
    ap.add_argument('--workdir', default='/tmp/align_rehearsal')
    args = ap.parse_args()
    root = args.workdir
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                        + ' --xla_force_host_platform_device_count=8').strip()
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    names, _ = build_stack(root, args.sections)
    write_configs(root)
    t0 = time.time()
    stages = [run_mode(root, m, env)
              for m in ('meshing', 'matching', 'optimization', 'rendering')]
    out = {'sections': len(names), 'stages': stages,
           'peak_child_rss_mb': round(resource.getrusage(
               resource.RUSAGE_CHILDREN).ru_maxrss / 1024, 1)}
    if all(s['rc'] == 0 for s in stages):
        match_err, n_matches = check_match_accuracy(root, names)
        ncc, n_rendered = check_overlay(root, names)
        out['match_err_px'] = round(match_err, 3)
        out['matches_first_pair'] = n_matches
        out['neighbor_corr_median'] = None if ncc is None else round(ncc, 3)
        out['drift_tracking_err_px'] = round(check_drift_tracking(
            root, names), 2)
        out['sections_rendered'] = n_rendered
        r90 = residue_p90(root)
        out['residue_p90_px'] = None if r90 is None else round(r90, 3)
        total = time.time() - t0
        out['sections_per_hour'] = round(len(names) / total * 3600, 1)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
