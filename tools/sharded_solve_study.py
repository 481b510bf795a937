"""Performance characterization of the z-sharded window solve.

The sharded ``stack_solve`` is one XLA program spanning a 1-D 'z'
device mesh — the multi-device replacement for the reference's
multi-node window handoff, feabas/aligner.py:909 + concurrent.py:147.
This study measures, on the 8-virtual-device CPU mesh at production DOF:

  1. iteration-count parity sharded vs unsharded (same system, same
     preconditioner, same tolerance) — CG math must not change when the
     z axis shards;
  2. displacement parity (max |u_sharded - u_unsharded|);
  3. per-iteration wall cost of each, and the per-shard share;
  4. the collective ledger per CG iteration, parsed from the compiled
     (post-SPMD) HLO: how many bytes ride the collective-permute (the
     z-neighbor crosslink halo) and the all-reduces (CG dots), per
     device, per iteration.

CPU wall times here are a statement about the CPU backend, not about an
accelerator; the collective byte counts carry over.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python tools/sharded_solve_study.py [--sections 80 --mesh-size 27]
(or let it re-exec itself into that environment).

Writes SHARDED_STUDY.json at the repo root.
"""

import argparse
import json
import os
import re
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reexec_cpu8():
    if os.environ.get('FEABAS_SHARD_STUDY_REEXEC') == '1':
        return
    env = dict(os.environ)
    env['FEABAS_SHARD_STUDY_REEXEC'] = '1'
    env['JAX_PLATFORMS'] = 'cpu'
    flags = env.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:
        env['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8').strip()
    pyp = [p for p in env.get('PYTHONPATH', '').split(os.pathsep) if p]
    env['PYTHONPATH'] = os.pathsep.join(pyp + [_ROOT])
    os.execve(sys.executable, [sys.executable] + sys.argv, env)


_DTYPE_BYTES = {'f32': 4, 'bf16': 2, 'f16': 2, 'f64': 8, 's32': 4,
                'u32': 4, 's8': 1, 'u8': 1, 'pred': 1, 's64': 8, 'u64': 8}


def _shape_bytes(sig):
    """Bytes of one 'dtype[d0,d1,...]' HLO shape string."""
    m = re.match(r'([a-z0-9]+)\[([0-9,]*)\]', sig)
    if not m:
        return 0
    nb = _DTYPE_BYTES.get(m.group(1), 4)
    dims = m.group(2)
    n = 1
    for d in dims.split(','):
        if d:
            n *= int(d)
    return n * nb


_COLLECTIVES = ('collective-permute', 'all-reduce', 'all-gather',
                'reduce-scatter', 'all-to-all')


def _split_computations(hlo_txt):
    """{computation_name: [lines]} from HLO text (computations start at
    column 0 with '<name> (params) -> ... {' or 'ENTRY <name> ...')."""
    comps = {}
    cur = None
    for line in hlo_txt.splitlines():
        m = re.match(r'(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$', line)
        if m and not line.startswith(' '):
            cur = m.group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    return comps


def _line_collective(line):
    """(op, bytes) if the line is a collective instruction, else None."""
    m = re.match(r'\s*%?[\w.\-]+\s*=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\]'
                 r'(?:\{[^}]*\})?))\s+([a-z\-]+)', line)
    if not m or m.group(2) not in _COLLECTIVES:
        return None
    shapes = re.findall(r'[a-z0-9]+\[[0-9,]*\]', m.group(1))
    return m.group(2), sum(_shape_bytes(s) for s in shapes)


def _while_body_collectives(hlo_txt):
    """Collective ops + payload bytes per CG iteration: everything in the
    while-loop body computation and computations it calls (fusions/calls),
    transitively. Post-SPMD shapes are PER-SHARD, so byte counts are
    per-device per-iteration."""
    comps = _split_computations(hlo_txt)
    bodies = {b.lstrip('%') for b in re.findall(r'body=%?([\w.\-]+)',
                                                hlo_txt)}
    # transitively include computations referenced from the body
    seen = set()
    frontier = [b for b in bodies if b in comps]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for line in comps.get(name, ()):
            for ref in re.findall(r'(?:calls=|to_apply=|%)([\w.\-]+)', line):
                if ref in comps and ref not in seen:
                    frontier.append(ref)
    out = {op: {'count': 0, 'bytes': 0} for op in _COLLECTIVES}
    for name in seen:
        for line in comps[name]:
            hit = _line_collective(line)
            if hit:
                out[hit[0]]['count'] += 1
                out[hit[0]]['bytes'] += hit[1]
    return out


def _build(S, mesh_size, ext=3000):
    import numpy as np
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.parallel.window import build_stack_system
    rng = np.random.default_rng(0)
    meshes = []
    for z in range(S):
        m = Mesh.from_bbox((0, 0, ext, ext), cartesian=True,
                           mesh_size=mesh_size, uid=z, name=f'z{z}',
                           resolution=4)
        m.set_translation((0, 0))
        meshes.append(m)
    meshes[0].locked = True
    xs, ys = np.meshgrid(np.linspace(100, ext - 100, 12),
                         np.linspace(100, ext - 100, 12))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    links = []
    for z in range(S - 1):
        d = rng.normal(0, 1.5, 2)
        tid0 = meshes[z].tri_finder(pts, gear='INITIAL', extrapolate=True)
        tid1 = meshes[z + 1].tri_finder(pts + d, gear='INITIAL',
                                        extrapolate=True)
        links.append({
            'idx0': meshes[z].triangles[tid0],
            'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
            'idx1': meshes[z + 1].triangles[tid1],
            'bary1': meshes[z + 1].cart2bary(pts + d, tid1,
                                             gear='INITIAL'),
            'weight': np.ones(len(pts), np.float32),
        })
    return build_stack_system(meshes, links)


def main():
    _reexec_cpu8()
    ap = argparse.ArgumentParser()
    ap.add_argument('--sections', type=int, default=80)
    ap.add_argument('--mesh-size', type=float, default=27)
    ap.add_argument('--maxiter', type=int, default=800)
    ap.add_argument('--repeats', type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.ops import fem
    from feabas_tpu.parallel.window import (stack_solve,
                                            shard_stack_system)

    devs = jax.devices()
    assert devs[0].platform == 'cpu' and len(devs) == 8, devs

    system = _build(args.sections, args.mesh_size)
    S, V = system['u'].shape[:2]
    dof = int(system['u'].size)
    tris0 = system['tris'] if system['tris'].ndim == 2 else system['tris'][0]
    T = tris0.shape[0]
    inc_np, imask_np = fem.build_incidence(tris0, V)
    print(f'# stack: S={S} V={V} T={T} DOF={dof}', flush=True)

    def run(sharded, maxiter):
        if sharded:
            sh = shard_stack_system(system, JMesh(np.array(devs), ('z',)))
            a = (sh['verts0'], sh['u'], sh['tris'], sh['multiplier'],
                 sh['poisson'], sh['links'], sh['r_rest'], sh['free'])
        else:
            keys = ('verts0', 'u', 'tris', 'multiplier', 'poisson')
            a = tuple(jnp.asarray(system[k]) for k in keys) + (
                tuple(jnp.asarray(x) for x in system['links']),
                jnp.asarray(system['r_rest']), jnp.asarray(system['free']))
        kw = dict(lam_s=0.1, maxiter=maxiter)
        if not sharded:
            kw.update(inc=jnp.asarray(inc_np), imask=jnp.asarray(imask_np))
        lowered = stack_solve.lower(*a, **kw)
        comp = lowered.compile()
        u, n_it, res = stack_solve(*a, **kw)
        u_np = np.asarray(u)
        wall = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            u2, n2, r2 = stack_solve(*a, **kw)
            _ = float(np.asarray(u2).sum())
            wall.append(time.perf_counter() - t0)
        return {'u': u_np, 'iters': int(np.asarray(n_it)),
                'res': float(np.asarray(res)), 'wall': min(wall),
                'hlo': comp.as_text()}

    uns = run(False, args.maxiter)
    sha = run(True, args.maxiter)

    parity = float(np.abs(uns['u'] - sha['u']).max())
    led = _while_body_collectives(sha['hlo'])
    cp_bytes = led['collective-permute']['bytes']
    ar_bytes = led['all-reduce']['bytes']
    ag_bytes = led['all-gather']['bytes']
    out = {
        'dof': dof, 'sections': S, 'verts_per_section': V,
        'tris_per_section': int(T),
        'unsharded_iters': uns['iters'], 'sharded_iters': sha['iters'],
        'iter_parity': round(sha['iters'] / max(uns['iters'], 1), 3),
        'displacement_parity_px': parity,
        'unsharded_wall_s': round(uns['wall'], 3),
        'sharded_wall_s': round(sha['wall'], 3),
        'unsharded_ms_per_iter': round(
            1e3 * uns['wall'] / max(uns['iters'], 1), 3),
        'sharded_ms_per_iter': round(
            1e3 * sha['wall'] / max(sha['iters'], 1), 3),
        'per_device_dof': dof // 8,
        'collectives_per_iter': {
            k: v for k, v in led.items() if v['count']},
        'collective_permute_bytes_per_iter_per_device': cp_bytes,
        'all_reduce_bytes_per_iter_per_device': ar_bytes,
        'all_gather_bytes_per_iter_per_device': ag_bytes,
        'residual_unsharded': uns['res'], 'residual_sharded': sha['res'],
    }
    path = os.path.join(_ROOT, 'SHARDED_STUDY.json')
    with open(path, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f'# wrote {path}')


if __name__ == '__main__':
    main()
