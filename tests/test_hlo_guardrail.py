"""Multi-chip lowering guardrail (round-3 VERDICT #10).

The multi-device check that runs without accelerators: compile the sharded solves on the 8-virtual-device CPU mesh, then assert
the compiled (post-SPMD-partitioning) HLO still contains the expected
collectives and keeps the big state arrays in per-shard shapes. A change
that silently de-shards a solve (e.g. an accidental full-gather of the
vertex state, or a dropped sharding annotation that makes XLA replicate
everything) flips these assertions before it ever reaches several cards.

Reference role: feabas scales window solves out via dask/SLURM
(feabas/concurrent.py:147, aligner.py:909); here one window's system is
ONE XLA program spanning the mesh, so the compiled module itself is the
distribution contract worth pinning.
"""

import numpy as np
import pytest


def _collective_counts(txt):
    return {k: txt.count(k) for k in
            ('all-reduce', 'collective-permute', 'all-gather',
             'all-to-all', 'reduce-scatter')}


def test_stack_solve_hlo_stays_sharded(workdir):
    import jax
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.parallel.window import stack_solve, shard_stack_system
    from test_parallel import _make_stack
    devices = np.array(jax.devices())
    assert devices.size == 8, 'conftest must provide 8 virtual devices'
    jmesh = JMesh(devices, ('z',))
    system, _ = _make_stack(S=8)
    sh = shard_stack_system(system, jmesh)
    args = (sh['verts0'], sh['u'], sh['tris'], sh['multiplier'],
            sh['poisson'], sh['links'], sh['r_rest'], sh['free'])
    comp = stack_solve.lower(*args, lam_s=0.01, maxiter=800).compile()
    txt = comp.as_text()
    c = _collective_counts(txt)
    # CG dot products must be global reductions; the z-neighbor crosslink
    # halo must ride a permute (not a host round-trip, not nothing)
    assert c['all-reduce'] >= 1, c
    assert c['collective-permute'] >= 1, c
    # de-shard detector: the (S, V, 2) vertex state must live in
    # per-shard [1, V, 2] form for the bulk of the program; a silent
    # re-replication flips this ratio hard (everything becomes [8,...])
    S, V = system['u'].shape[:2]
    full = txt.count(f'f32[{S},{V},2]')
    shard = txt.count(f'f32[{S // 8},{V},2]')
    assert shard > full, (shard, full)
    # and the executed result must actually come back sharded: one
    # (1, V, 2) shard per device
    u_new, n_it, res = stack_solve(*args, lam_s=0.01, maxiter=800)
    assert len(u_new.sharding.device_set) == 8
    shapes = {s.data.shape for s in u_new.addressable_shards}
    assert shapes == {(S // 8, V, 2)}, shapes


def test_montage_solve_hlo_stays_sharded(workdir):
    import jax
    from feabas_tpu.parallel import montage
    from test_montage_sharded import _grid_slm
    devices = jax.devices()
    assert len(devices) == 8
    jmesh = montage.montage_device_mesh()
    slm, _ = _grid_slm(rows=4, cols=8)
    system = montage.slm_montage_to_tiles(slm)
    assert system is not None
    system['agg'], n_agg = montage.montage_aggregates(
        system['verts0_host'].mean(axis=1))
    padded = montage.pad_montage_system(system, 8)
    sh = montage.shard_montage_system(padded, jmesh)
    args = (sh['verts0'], sh['u'], sh['tris'], sh['multiplier'],
            sh['poisson'], sh['links'], sh['r_rest'], sh['free'])
    kw = dict(lam_ratio=1.0, tol=1e-7, atol=0.0, maxiter=600,
              agg=sh['agg'], n_agg=n_agg)
    comp = montage.montage_solve.lower(*args, **kw).compile()
    txt = comp.as_text()
    c = _collective_counts(txt)
    # tile-sharded montage: the CG dots AND the cross-shard link
    # contributions (replicated link table, sharded state) all lower to
    # all-reduce on this mesh — dozens of them; zero means de-sharded
    assert c['all-reduce'] >= 1, c
    Mp, V = padded['u'].shape[:2]
    full = txt.count(f'f32[{Mp},{V},2]')
    shard = txt.count(f'f32[{Mp // 8},{V},2]')
    assert shard > full, (shard, full)
    new_u, stats = montage.montage_solve(*args, **kw)
    assert len(new_u.sharding.device_set) == 8
    shapes = {s.data.shape for s in new_u.addressable_shards}
    assert shapes == {(Mp // 8, V, 2)}, shapes


def test_stack_solve_iteration_collectives_are_halo_sized(workdir):
    """Regression pin for the round-5 all-gather fix: the CG while-body's
    per-iteration collectives must be one-section halo permutes + scalar
    dot all-reduces — NOT full-state all-gathers (the original (S-1)-axis
    link formulation re-gathered the whole (S, V, 2) state 3x per
    iteration; tools/sharded_solve_study.py measured 24 MB/device/iter at
    2M DOF)."""
    import os
    import sys
    import jax
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.parallel.window import stack_solve, shard_stack_system
    from test_parallel import _make_stack
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    'tools'))
    from sharded_solve_study import _while_body_collectives
    import numpy as np
    devices = np.array(jax.devices())
    assert devices.size == 8
    system, _ = _make_stack(S=8)
    sh = shard_stack_system(system, JMesh(devices, ('z',)))
    args = (sh['verts0'], sh['u'], sh['tris'], sh['multiplier'],
            sh['poisson'], sh['links'], sh['r_rest'], sh['free'])
    txt = stack_solve.lower(*args, lam_s=0.01, maxiter=800).compile().as_text()
    led = _while_body_collectives(txt)
    V = system['u'].shape[1]
    fbytes = np.dtype(np.asarray(system['u']).dtype).itemsize
    halo = V * 2 * fbytes                       # one section slice
    # exactly the two halo permutes (roll -1 of x, roll +1 of the side-1
    # scatter), each one section
    assert led['collective-permute']['count'] == 2, led
    assert led['collective-permute']['bytes'] == 2 * halo, (led, halo)
    # no full-state all-gathers: anything bigger than a couple of halo
    # slices per iteration means the partitioner de-sharded a scatter
    assert led['all-gather']['bytes'] <= 2 * halo, led
    assert led['reduce-scatter']['bytes'] <= 2 * halo, led


def test_stack_solve_stencil_hlo_stays_sharded(workdir):
    """Same de-shard/collective pins for the lattice-STENCIL solve — the
    production path for grid/staggered window meshes (stack_solve
    grid_shape): CG dots all-reduce, the crosslink halo rides permutes,
    the vertex state stays per-shard, and the while-body collectives
    stay halo-sized (the stencil matvec is section-local, so it must add
    NO collectives of its own)."""
    import os
    import sys
    import jax
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.parallel.window import stack_solve, shard_stack_system
    from test_parallel import _make_stack
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    'tools'))
    from sharded_solve_study import _while_body_collectives
    from feabas_tpu.parallel.window import build_link_transpose
    devices = np.array(jax.devices())
    assert devices.size == 8
    system, _ = _make_stack(S=8)
    assert system.get('grid_shape') is not None
    system['linc'] = build_link_transpose(system['links'], 8,
                                          system['u'].shape[1])
    sh = shard_stack_system(system, JMesh(devices, ('z',)))
    args = (sh['verts0'], sh['u'], sh['tris'], sh['multiplier'],
            sh['poisson'], sh['links'], sh['r_rest'], sh['free'])
    kw = dict(lam_s=0.01, maxiter=800, grid_shape=system['grid_shape'],
              linc=sh['linc'])
    txt = stack_solve.lower(*args, **kw).compile().as_text()
    c = _collective_counts(txt)
    assert c['all-reduce'] >= 1, c
    assert c['collective-permute'] >= 1, c
    S, V = system['u'].shape[:2]
    full = txt.count(f'f32[{S},{V},2]')
    shard = txt.count(f'f32[{S // 8},{V},2]')
    assert shard > full, (shard, full)
    led = _while_body_collectives(txt)
    fbytes = np.dtype(np.asarray(system['u']).dtype).itemsize
    halo = V * 2 * fbytes
    L = np.asarray(system['links'][4]).shape[1]
    c1_halo = 3 * L * 2 * fbytes
    # roll(x) carries a one-section V halo; the side-1 link transpose
    # now rolls only its 3L contribution rows (was a second full-V halo)
    assert led['collective-permute']['count'] == 2, led
    assert led['collective-permute']['bytes'] == halo + c1_halo, (
        led, halo, c1_halo)
    assert led['all-gather']['bytes'] <= 2 * halo, led
    u_new, n_it, res = stack_solve(*args, **kw)
    assert len(u_new.sharding.device_set) == 8
    shapes = {s.data.shape for s in u_new.addressable_shards}
    assert shapes == {(S // 8, V, 2)}, shapes
