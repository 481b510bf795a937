"""Device-sharded montage elastic solve.

A stitching section couples hundreds-to-thousands of tile meshes of ONE
topology through arbitrary-pair crosslinks (2D neighbor overlaps) — a
block-diagonal stiffness plus a sparse coupling graph. Tiles shard across
devices on a 1-D 'm' mesh axis: per-tile FEM matvecs are local vmaps
(never cross devices), and only the link coupling gathers/scatters across
the sharded tile axis, which XLA lowers to all-gather / reduce-scatter
between devices. CG dot products become global reductions automatically.

This is the multi-device scale-out of the reference's per-section montage solve
(``feabas/stitcher.py:961`` — one scipy sparse system over all tiles on
one host). The z-window analog with chain links is
``feabas_tpu/parallel/window.py``; this module handles the general pair
graph so MultiSEM-scale sections (10k+ tiles) span all devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from feabas_tpu.ops import fem


def slm_montage_to_tiles(slm, shape_gear=None, start_gear=None):
    """Bucket an SLM into the stacked tile form, or None.

    Bucketable when every mesh shares one topology AND one material
    layout, and every material is linear ENG with no stiffness curve.
    Links may couple ANY mesh pair (unlike the z-chain window form).
    Returns a dict of batched host arrays; positions are NOT centered —
    callers center for f32 (see ``center_montage_system``).
    """
    from feabas_tpu import constant as const
    shape_gear = const.MESH_GEAR_FIXED if shape_gear is None else shape_gear
    start_gear = const.MESH_GEAR_MOVING if start_gear is None else start_gear
    meshes = slm.meshes
    if len(meshes) < 2 or not slm.is_linear:
        return None
    T0 = meshes[0].triangles
    mat0 = meshes[0].material_ids
    for m in meshes:
        if (m.triangles.shape != T0.shape
                or not np.array_equal(m.triangles, T0)
                or not np.array_equal(m.material_ids, mat0)):
            return None
        for g in m.element_arrays(gear=shape_gear):
            if g['knots'] is not None:
                return None
    uid2idx = {m.uid: i for i, m in enumerate(meshes)}
    M = len(meshes)
    V = meshes[0].num_vertices
    m0l, i0l, b0l, m1l, i1l, b1l, wl = [], [], [], [], [], [], []
    for l in slm.active_links():
        j0, j1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
        tid0, bary0 = l._tid0, l._bary0
        tid1, bary1 = l._tid1, l._bary1
        n = bary0.shape[0]
        m0l.append(np.full(n, j0, np.int32))
        i0l.append(meshes[j0].triangles[tid0])
        b0l.append(bary0)
        m1l.append(np.full(n, j1, np.int32))
        i1l.append(meshes[j1].triangles[tid1])
        b1l.append(bary1)
        wl.append(l.weight())
    if not wl:
        return None
    m0 = np.concatenate(m0l).astype(np.int32)
    idx0 = np.concatenate(i0l).astype(np.int32)
    bary0 = np.concatenate(b0l).astype(np.float32)
    m1 = np.concatenate(m1l).astype(np.int32)
    idx1 = np.concatenate(i1l).astype(np.int32)
    bary1 = np.concatenate(b1l).astype(np.float32)
    weight = np.concatenate(wl).astype(np.float32)
    # pow2 bucket so the jitted solve is reused across sections (padding
    # rows have weight 0 and are inert)
    from feabas_tpu.parallel.window import _pow2
    L = weight.shape[0]
    Lb = _pow2(L)  # shared bucketing rule keeps jit caches in sync
    if Lb > L:
        pad = Lb - L
        m0 = np.concatenate([m0, np.zeros(pad, np.int32)])
        idx0 = np.concatenate([idx0, np.zeros((pad, 3), np.int32)])
        bary0 = np.concatenate([bary0, np.zeros((pad, 3), np.float32)])
        m1 = np.concatenate([m1, np.zeros(pad, np.int32)])
        idx1 = np.concatenate([idx1, np.zeros((pad, 3), np.int32)])
        bary1 = np.concatenate([bary1, np.zeros((pad, 3), np.float32)])
        weight = np.concatenate([weight, np.zeros(pad, np.float32)])
    verts0 = np.stack([m.vertices_w_offset(shape_gear) for m in meshes])
    pos = np.stack([m.vertices_w_offset(start_gear) for m in meshes])
    # DISPLACEMENT FORM for f32 device math: absolute world coordinates at
    # MultiSEM extents (~1e6 px) quantize at ~0.03-0.06 px in f32, near the
    # 0.1 px parity target. The solve only ever needs (a) per-tile LOCAL
    # rest coordinates (tile-sized, for the shape matrices — translation
    # invariant), (b) the start displacement u = pos - verts0 (small), and
    # (c) the per-link-point REST residual (stage error, a few px) — all
    # computed here in f64 and safe to carry in f32. World positions are
    # reassembled on the host in f64 at commit time.
    centers = verts0.mean(axis=1)                       # (M, 2) f64
    verts0_local = verts0 - centers[:, None, :]
    u = pos - verts0
    b0d = bary0.astype(np.float64)
    b1d = bary1.astype(np.float64)
    p0r = (verts0[m0[:, None], idx0] * b0d[..., None]).sum(axis=1)
    p1r = (verts0[m1[:, None], idx1] * b1d[..., None]).sum(axis=1)
    r_rest = (p1r - p0r).astype(np.float32)             # (L, 2)
    mult, poisson = [], []
    for m in meshes:
        groups = m.element_arrays(gear=shape_gear)
        mult.append(np.concatenate([g['multiplier'] for g in groups]))
        poisson.append(np.concatenate([g['poisson'] for g in groups]))
    locked = np.asarray([m.locked for m in meshes], np.float32)
    return {
        'tris': np.asarray(T0, np.int32),
        'verts0': verts0_local.astype(np.float32),
        'u': u.astype(np.float32),
        'r_rest': r_rest,
        'verts0_host': verts0,
        'multiplier': np.stack(mult).astype(np.float32),
        'poisson': np.stack(poisson).astype(np.float32),
        'links': (m0, idx0, bary0, m1, idx1, bary1, weight),
        'free': (1.0 - locked)[:, None, None].astype(np.float32),
        'num_meshes': M, 'num_vertices': V,
    }


def montage_rigid_modes(system):
    """Orthonormal rigid modes (tx, ty, infinitesimal rotation about the
    component centroid) of every fully-free link-connected tile component,
    stacked (K, M, V, 2), or None when all components are anchored.
    Same role as ``SLM._rigid_deflation_modes`` (reference extra-DOF
    removal, optimizer.py:1362-1377): the rotation direction of an
    unanchored montage has near-zero curvature but nonzero gradient, so
    an unprojected solve can rotate the whole section spuriously."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    M = system['num_meshes']
    V = system['num_vertices']
    m0, _, _, m1, _, _, w = system['links']
    act = w > 0
    adj = coo_matrix((np.ones(int(act.sum())), (m0[act], m1[act])),
                     shape=(M, M))
    _, labels = connected_components(adj, directed=False)
    locked = system['free'][:M, 0, 0] == 0
    verts = system['verts0_host']                       # (M, V, 2) f64
    from feabas_tpu.optimizer import rigid_modes_flat
    slot = np.arange(M * V).reshape(M, V)
    comps = []
    for lbl in np.unique(labels):
        sel = labels == lbl
        if locked[sel].any():
            continue
        comps.append((slot[sel].ravel(), verts[sel].reshape(-1, 2)))
    modes = rigid_modes_flat(M * V, comps)
    return None if modes is None else modes.reshape(-1, M, V, 2)


def montage_aggregates(centers, max_coarse=4096, target=2048):
    """Spatially-coherent tile aggregates for the coarse preconditioner.

    Identity below ``max_coarse`` tiles (exact per-tile coarse space);
    above, tiles sort by the Morton code of their quantized centers and
    chunk into ~``target`` contiguous runs, so each aggregate is a
    compact neighborhood (whole-mFoV-scale modes stay in the coarse
    space at any tile count). Returns (agg (M,) int32, n_agg)."""
    from feabas_tpu.common import z_order
    M = centers.shape[0]
    if M <= max_coarse:
        return np.arange(M, dtype=np.int32), M
    c = np.asarray(centers, np.float64)
    span = max(float(np.ptp(c[:, 0])), float(np.ptp(c[:, 1])), 1.0)
    q = np.floor((c - c.min(axis=0)) / span * 1024).astype(np.int64)
    order = z_order(q[:, ::-1])            # (row, col) convention
    run = -(-M // int(target))
    agg = np.empty(M, np.int32)
    agg[order] = np.arange(M, dtype=np.int32) // run
    return agg, int(agg.max()) + 1


def pad_montage_system(system, n_devices):
    """Pad the tile axis to a multiple of ``n_devices`` with inert locked
    copies of tile 0 (no links touch them; free=0 keeps them fixed)."""
    M = system['u'].shape[0]
    Mp = -(-M // n_devices) * n_devices
    if Mp == M:
        return system
    pad = Mp - M
    out = dict(system)
    for k in ('verts0', 'u', 'multiplier', 'poisson'):
        a = system[k]
        out[k] = np.concatenate([a, np.repeat(a[:1], pad, axis=0)], axis=0)
    if 'agg' in system:
        out['agg'] = np.concatenate(
            [system['agg'], np.zeros(pad, np.int32)])
    out['free'] = np.concatenate(
        [system['free'], np.zeros((pad, 1, 1), np.float32)], axis=0)
    return out


def shard_montage_system(system, device_mesh):
    """Place the batched arrays on a 1-D 'm' device mesh: tile-indexed
    arrays shard; triangles and the link table replicate (links index
    across shards — XLA inserts the gather/reduce collectives)."""
    msh = NamedSharding(device_mesh, P('m'))
    rep = NamedSharding(device_mesh, P())
    out = dict(system)
    for k in ('verts0', 'u', 'multiplier', 'poisson', 'free'):
        out[k] = jax.device_put(system[k], msh)
    out['tris'] = jax.device_put(system['tris'], rep)
    out['r_rest'] = jax.device_put(system['r_rest'], rep)
    if 'agg' in system:
        out['agg'] = jax.device_put(np.asarray(system['agg'], np.int32),
                                    rep)
    out['links'] = tuple(jax.device_put(a, rep) for a in system['links'])
    return out


def montage_device_mesh(max_devices=None):
    """1-D 'm' mesh over the local devices."""
    devs = jax.devices()
    if max_devices is not None:
        devs = devs[:max_devices]
    return JMesh(np.array(devs), ('m',))


def _montage_matvec(x, Ke, tris, links, free, lam_s, lam_c):
    """A @ x for the stacked montage system; x: (M, V, 2).

    The per-tile stiffness vmap is shard-local; the link gather
    x[m, idx] and the scatter back cross the sharded tile axis.
    """
    x = x * free
    y = jax.vmap(lambda xi, Ki: fem.stiffness_matvec(xi, Ki, tris))(x, Ke) * lam_s
    m0, idx0, bary0, m1, idx1, bary1, weight = links
    p0 = (x[m0[:, None], idx0] * bary0[..., None]).sum(axis=1)
    p1 = (x[m1[:, None], idx1] * bary1[..., None]).sum(axis=1)
    r = (p1 - p0) * (weight ** 2)[:, None] * lam_c
    y = y.at[m0[:, None], idx0].add(-bary0[:, :, None] * r[:, None, :])
    y = y.at[m1[:, None], idx1].add(bary1[:, :, None] * r[:, None, :])
    return y * free


@functools.partial(jax.jit, static_argnames=('maxiter', 'n_agg'))
def montage_solve(verts0, u, tris, multiplier, poisson, links, r_rest, free,
                  lam_ratio=1.0, tol=1e-7, atol=0.0, maxiter=2000,
                  agg=None, n_agg=None, modes=None):
    """One montage relaxation in displacement form; returns
    (new_u (M,V,2), stats (2,2)).

    ``agg``/``n_agg``: optional per-tile aggregate ids for the coarse
    preconditioner space. Identity (one aggregate per tile) reproduces
    the exact link-Laplacian coarse solve; spatially-coherent aggregates
    keep the coarse system invertible at 10k+ tiles (MultiSEM scale),
    where a dense per-tile (M, M) inverse would not fit.

    ``verts0`` holds per-tile LOCAL rest coordinates (shape matrices are
    translation invariant), ``u`` the start displacement, and ``r_rest``
    the per-link-point rest residual — all small magnitudes, so f32 keeps
    sub-0.001 px resolution regardless of the section's world extent.
    Minimizes lam_s/2 u'Ku + 1/2 |W C p|^2 over free tiles with
    trace-ratio lambda balance (matches SLM._balance_lambdas semantics);
    stats = [[bnorm, res], [cost0, n_it]]. All tile-indexed inputs may be
    sharded along the leading axis.
    """
    dt = u.dtype
    M, V = u.shape[0], u.shape[1]

    def per_tile(v0):
        return fem.shape_matrices(v0[tris])
    B, area2 = jax.vmap(per_tile)(verts0)
    Ke = jax.vmap(fem.eng_element_stiffness)(B, area2, multiplier, poisson)
    r_rest = r_rest.astype(dt)

    m0, idx0, bary0, m1, idx1, bary1, weight = links
    bary0 = bary0.astype(dt)
    bary1 = bary1.astype(dt)
    weight = weight.astype(dt)
    links = (m0, idx0, bary0, m1, idx1, bary1, weight)

    # trace-ratio balance restricted to crosslinked dofs
    dK = jax.vmap(lambda Ki: fem.stiffness_diag(Ki, tris, V))(Ke)
    w2b0 = (bary0 ** 2) * (weight ** 2)[:, None]
    w2b1 = (bary1 ** 2) * (weight ** 2)[:, None]
    dC = jnp.zeros((M, V, 2), dt)
    dC = dC.at[m0[:, None], idx0].add(
        w2b0[:, :, None] * jnp.ones((1, 1, 2), dt))
    dC = dC.at[m1[:, None], idx1].add(
        w2b1[:, :, None] * jnp.ones((1, 1, 2), dt))
    tr_c = jnp.sum(dC)
    tr_k = jnp.sum(jnp.where(dC != 0, dK, 0.0))
    okl = (tr_c > 0) & (tr_k > 0)
    lam_s = jnp.where(okl, lam_ratio * tr_c / jnp.where(tr_k > 0, tr_k, 1.0),
                      1.0)
    lam_c = jnp.asarray(1.0, dt)

    from feabas_tpu.optimizer import _mode_projector
    project = _mode_projector(None if modes is None else modes.astype(dt))

    def matvec(x):
        return project(_montage_matvec(project(x), Ke, tris, links, free,
                                       lam_s, lam_c))

    # rhs = -(lam_s K u + C^T W r(pos)); r(pos) = r_rest + (U1 - U0)
    b = -jax.vmap(lambda ui, Ki: fem.stiffness_matvec(ui, Ki, tris))(u, Ke) \
        * lam_s
    U0 = (u[m0[:, None], idx0] * bary0[..., None]).sum(axis=1)
    U1 = (u[m1[:, None], idx1] * bary1[..., None]).sum(axis=1)
    r_abs = r_rest + U1 - U0
    r0 = r_abs * (weight ** 2)[:, None]
    b = b.at[m1[:, None], idx1].add(-bary1[:, :, None] * r0[:, None, :]
                                    * lam_c)
    b = b.at[m0[:, None], idx0].add(bary0[:, :, None] * r0[:, None, :]
                                    * lam_c)
    b = b * free

    diag = dK * lam_s + dC * lam_c
    diag = jnp.where(free > 0, diag, 1.0)
    # two-level preconditioner: per-tile uniform translations are exact
    # stiffness null modes, so the montage's slow modes live in the
    # link-graph translation Laplacian (same idea as the window solve's
    # z-chain coarse space). Small sections invert the exact per-tile
    # (M,M) system; above the identity gate, tiles AGGREGATE into
    # spatially-coherent groups (``agg``) and the (A,A) aggregate
    # Laplacian P_f' L P_f carries the slow whole-region modes — this
    # keeps the coarse solve dense-invertible at MultiSEM scale (10k+
    # tiles) instead of dropping to plain Jacobi.
    precond = None
    if n_agg is None and M <= 4096:
        agg = jnp.arange(M, dtype=jnp.int32)
        n_agg = M
    if n_agg is not None and agg is not None:
        A = int(n_agg)
        freed = free[:, 0, 0]
        freed_agg = jnp.zeros(A, dt).at[agg].max(freed)
        w2 = (weight ** 2) * lam_c
        a0 = agg[m0]
        a1 = agg[m1]
        # exact free-subspace restriction: a locked endpoint contributes
        # its diagonal mass only through the OTHER (free) tile
        f0 = freed[m0]
        f1 = freed[m1]
        Ac = jnp.zeros((A, A), dt)
        Ac = Ac.at[a0, a0].add(w2 * f0).at[a1, a1].add(w2 * f1)
        Ac = Ac.at[a0, a1].add(-w2 * f0 * f1).at[a1, a0].add(-w2 * f0 * f1)
        reg = jnp.maximum(jnp.diagonal(Ac).max(), 1.0)
        Ac = Ac + jnp.diag(jnp.where(freed_agg > 0, 1e-6 * reg, reg))
        Acinv = jnp.linalg.inv(Ac)
        minv = jnp.where(diag > 1e-12,
                         1.0 / jnp.where(diag > 1e-12, diag, 1.0), 1.0)

        def precond(r):
            rt = r.sum(axis=1)                          # (M, 2)
            rc = jnp.zeros((A, 2), dt).at[agg].add(rt)
            cc = jnp.einsum('st,tc->sc', Acinv, rc,
                            precision=fem.MATMUL_PRECISION)
            cc = cc * freed_agg[:, None]
            return r * minv + cc[agg][:, None, :] * free

    b = project(b)
    if precond is not None and modes is not None:
        inner_precond = precond
        precond = lambda r: project(inner_precond(project(r)))
    dx, n_it, res = fem.cg_solve(matvec, b, diag=diag, tol=tol, atol=atol,
                                 maxiter=maxiter, precond=precond)
    dx = project(dx)
    cost0 = jnp.linalg.norm(r_abs * weight[:, None])
    stats = jnp.stack([jnp.stack([jnp.linalg.norm(b), res]),
                       jnp.stack([cost0, n_it.astype(dt)])])
    return u + dx * free, stats


def sharded_montage_linear_solve(slm, lam_ratio, shape_gear=None,
                                 start_gear=None, target_gear=None,
                                 tol=1e-7, atol=0.0, maxiter=2000,
                                 device_mesh=None,
                                 commit_non_converged=False):
    """Drop-in sharded replacement for one fused-ENG linear solve.

    Buckets the SLM, shards it over all local devices, solves, and — on
    convergence (or always, with ``commit_non_converged``, matching the
    single-device fused path under check_converge=False) — commits
    positions into ``target_gear`` for the free meshes. Returns
    (cost0, cost1, converged) or None when not bucketable.
    """
    from feabas_tpu import constant as const
    target_gear = const.MESH_GEAR_MOVING if target_gear is None else target_gear
    system = slm_montage_to_tiles(slm, shape_gear=shape_gear,
                                  start_gear=start_gear)
    if system is None:
        return None
    jmesh = device_mesh if device_mesh is not None else montage_device_mesh()
    n_dev = jmesh.devices.size
    M = system['num_meshes']
    # coarse-space aggregates: identity (exact) up to 4096 tiles,
    # Morton-run neighborhoods beyond — the preconditioner stays active
    # at MultiSEM scale instead of falling back to plain Jacobi
    system['agg'], n_agg = montage_aggregates(
        system['verts0_host'].mean(axis=1))
    modes = montage_rigid_modes(system)
    padded = pad_montage_system(system, n_dev)
    sharded = shard_montage_system(padded, jmesh)
    modes_j = None
    if modes is not None:
        Mp = padded['u'].shape[0]
        if Mp > modes.shape[1]:
            modes = np.concatenate(
                [modes, np.zeros((modes.shape[0], Mp - modes.shape[1],
                                  modes.shape[2], 2))], axis=1)
        modes_j = jax.device_put(
            modes.astype(np.float32), NamedSharding(jmesh, P(None, 'm')))
    new_u, stats = montage_solve(
        sharded['verts0'], sharded['u'], sharded['tris'],
        sharded['multiplier'], sharded['poisson'], sharded['links'],
        sharded['r_rest'], sharded['free'], lam_ratio=float(lam_ratio),
        tol=float(tol), atol=float(atol), maxiter=int(maxiter),
        agg=sharded['agg'], n_agg=n_agg, modes=modes_j)
    stats = np.asarray(stats)
    bnorm, res = float(stats[0, 0]), float(stats[0, 1])
    cost0 = float(stats[1, 0])
    ok = res < bnorm or res <= max(tol * bnorm, atol)
    if not ok and not commit_non_converged:
        return cost0, cost0, False
    # reassemble world positions on the host in f64
    pos = system['verts0_host'] + np.asarray(new_u, np.float64)[:M]
    for k, m in enumerate(slm.meshes):
        if m.locked:
            continue
        chunk = pos[k]
        c = chunk.mean(axis=0, keepdims=True)
        m.set_vertices(chunk - c, target_gear, offset=c)
    r1 = slm.match_residues(gear=target_gear)
    w_all = np.concatenate([l.weight() for l in slm.active_links()]) \
        if slm.active_links() else np.zeros(0)
    cost1 = float(np.linalg.norm(r1 * w_all)) if r1.size else 0.0
    return cost0, cost1, ok
