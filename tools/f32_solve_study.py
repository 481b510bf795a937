"""f32 vs f64 window solve at production DOF, on the real accelerator.

The 2M-DOF convergence study needs an explicit
f32-vs-f64 comparison (iterations, wall, displacement parity) so the
production dtype is a measured choice, not a default. The system is the
convergence-study workload (80 sections of 3000^2 cartesian meshes,
mesh_size 27 -> ~2.0M DOF, soft diagonal wrinkle bands), solved by the
same two-level-preconditioned CG both ways:

  - f32: the shipped path — displacement-form arrays are built f32
    (parallel/window.py:129) and the device CG runs in f32;
  - f64: the same arrays cast to f64, run under JAX_ENABLE_X64 (the
    accuracy reference, not a production option).

The parent never imports jax (one process holds the accelerator at a
time); each dtype runs in its own subprocess and saves displacements to
npz.

Run:  python tools/f32_solve_study.py [--sections 80 --mesh-size 27]
Writes F32_STUDY.json at the repo root.
"""

import argparse
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r'''
import json, sys, time
import numpy as np
sys.path.insert(0, {root!r})
from feabas_tpu import config
config.enable_compile_cache()
import jax
import jax.numpy as jnp
from feabas_tpu.mesh import Mesh
from feabas_tpu.ops import fem
from feabas_tpu.parallel.window import build_stack_system, stack_solve

S, mesh_size, maxiter, f64, out_npz = {sections}, {mesh_size}, \
    {maxiter}, {f64}, {out_npz!r}
rng = np.random.default_rng(0)
meshes = []
for z in range(S):
    m = Mesh.from_bbox((0, 0, 3000, 3000), cartesian=True,
                       mesh_size=mesh_size, uid=z, name=f'z{{z}}',
                       resolution=4)
    m.set_translation((0, 0))
    meshes.append(m)
meshes[0].locked = True
xs, ys = np.meshgrid(np.linspace(100, 2900, 12), np.linspace(100, 2900, 12))
pts = np.stack([xs.ravel(), ys.ravel()], -1)
links = []
for z in range(S - 1):
    d = rng.normal(0, 1.5, 2)
    tid0 = meshes[z].tri_finder(pts, gear='INITIAL', extrapolate=True)
    tid1 = meshes[z + 1].tri_finder(pts + d, gear='INITIAL',
                                    extrapolate=True)
    links.append({{'idx0': meshes[z].triangles[tid0],
                   'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
                   'idx1': meshes[z + 1].triangles[tid1],
                   'bary1': meshes[z + 1].cart2bary(pts + d, tid1,
                                                    gear='INITIAL'),
                   'weight': np.ones(len(pts), np.float32)}})
system = build_stack_system(meshes, links)
# wrinkle bands: heterogeneous stiffness, the convergence-study regime
mult = np.asarray(system['multiplier']).copy()
t0s = system['tris'] if np.asarray(system['tris']).ndim == 2 \
    else system['tris'][0]
for z in range(S):
    v0 = np.asarray(system['verts0'][z])
    cent = v0[np.asarray(t0s)].mean(axis=1)
    band = np.abs(cent[:, 0] - cent[:, 1] - (z % 7 - 3) * 150) < 60
    mult[z, band] *= 0.02
system['multiplier'] = mult
ft = np.float64 if f64 else np.float32
keys = ('verts0', 'u', 'tris', 'multiplier', 'poisson')
args = {{k: jnp.asarray(np.asarray(system[k]).astype(ft)
                        if np.asarray(system[k]).dtype.kind == 'f'
                        else system[k]) for k in keys}}
largs = tuple(jnp.asarray(np.asarray(a).astype(ft)
                          if np.asarray(a).dtype.kind == 'f' else a)
              for a in system['links'])
r_rest = jnp.asarray(system['r_rest'].astype(ft))
free = jnp.asarray(system['free'].astype(ft))
tris0 = system['tris'] if system['tris'].ndim == 2 else system['tris'][0]
inc1, imask1 = fem.build_incidence(tris0, system['verts0'].shape[1])
inc, imask = jnp.asarray(inc1), jnp.asarray(imask1.astype(ft))

def run():
    return stack_solve(args['verts0'], args['u'], args['tris'],
                       args['multiplier'], args['poisson'], largs,
                       r_rest, free, lam_s=0.1, maxiter=maxiter,
                       inc=inc, imask=imask)

u, n_it, res = run()
u_np = np.asarray(u)
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    u2, n2, r2 = run()
    _ = float(np.asarray(u2).sum())
    walls.append(time.perf_counter() - t0)
np.savez(out_npz, u=u_np, iters=int(np.asarray(n_it)),
         res=float(np.asarray(res)), wall=min(walls),
         dof=int(u_np.size))
print(json.dumps({{'iters': int(np.asarray(n_it)), 'wall': min(walls),
                   'res': float(np.asarray(res)),
                   'dof': int(u_np.size)}}))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--sections', type=int, default=80)
    ap.add_argument('--mesh-size', type=float, default=27)
    ap.add_argument('--maxiter', type=int, default=800)
    ap.add_argument('--reuse', action='store_true',
                    help='reuse an existing /tmp/f32_study_<tag>.npz '
                         'instead of re-running that leg')
    args = ap.parse_args()

    import numpy as np
    results = {}
    notes = {}

    def run_leg(tag, f64, platform=None):
        out_npz = f'/tmp/f32_study_{tag}.npz'
        code = _CHILD.format(root=_ROOT, sections=args.sections,
                             mesh_size=args.mesh_size,
                             maxiter=args.maxiter, f64=f64,
                             out_npz=out_npz)
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            [_ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                       if p])
        if f64:
            env['JAX_ENABLE_X64'] = 'True'
        else:
            env.pop('JAX_ENABLE_X64', None)
        if platform:
            env['JAX_PLATFORMS'] = platform
        if args.reuse and os.path.exists(out_npz):
            import numpy as _np
            d = _np.load(out_npz)
            print(f'# {tag}: reusing {out_npz}', flush=True)
            return {'u': d['u'], 'iters': int(d['iters']),
                    'res': float(d['res']), 'wall': float(d['wall']),
                    'dof': int(d['dof'])}
        print(f'# running {tag} child...', flush=True)
        if os.path.exists(out_npz):
            os.remove(out_npz)
        r = subprocess.run([sys.executable, '-c', code], env=env,
                           capture_output=True, text=True, timeout=3600)
        if r.returncode != 0:
            print(r.stdout[-1500:])
            print(r.stderr[-1500:])
            return None
        line = r.stdout.strip().splitlines()[-1]
        out = json.loads(line)
        out['u'] = np.load(out_npz)['u']
        print(f'# {tag}: {line}', flush=True)
        return out

    results['f32'] = run_leg('f32', False)
    if results['f32'] is None:
        raise SystemExit('f32 child failed')
    # f64 accuracy reference: the accelerator first; if the fully-f64
    # program does not compile there, the CPU backend — the reference's
    # own substrate — gives the parity truth, and the notes say so.
    results['f64'] = run_leg('f64', True)
    if results['f64'] is None:
        notes['f64_on_accelerator'] = ('f64 solve failed on the '
                                       'accelerator — f64 reference '
                                       'ran on the CPU backend instead')
        results['f64'] = run_leg('f64_cpu', True, platform='cpu')
        if results['f64'] is None:
            raise SystemExit('f64 reference failed on CPU too')

    u32, u64 = results['f32']['u'], results['f64']['u']
    parity = float(np.abs(u32.astype(np.float64) - u64).max())
    out = {
        'dof': results['f32']['dof'],
        'f32_iters': results['f32']['iters'],
        'f64_iters': results['f64']['iters'],
        'f32_wall_s': round(results['f32']['wall'], 3),
        'f64_wall_s': round(results['f64']['wall'], 3),
        'f32_residual': results['f32']['res'],
        'f64_residual': results['f64']['res'],
        'displacement_parity_px': parity,
        'speedup_f32_over_f64': round(
            results['f64']['wall'] / max(results['f32']['wall'], 1e-9), 2),
        'notes': notes,
    }
    with open(os.path.join(_ROOT, 'F32_STUDY.json'), 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
