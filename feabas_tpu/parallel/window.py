"""Multi-chip sliding-window elastic solve.

The 3D alignment relaxation couples consecutive sections with crosslinks
while each section carries its own stiffness — a block-tridiagonal system
along z. Here sections shard across devices on a 1-D ``jax.sharding.Mesh``
('z' axis): intra-section element stiffness matvecs are fully local
(vmapped over the section axis), and the z-neighbor crosslink coupling
slices across the section axis, which XLA lowers to halo exchanges
between devices. CG dot products become global ``psum``-style
reductions automatically.

This is the multi-device replacement for the reference's buffer-overlap sliding
window (``feabas/aligner.py:538-675``): instead of re-solving overlapping
windows sequentially on one host, one window spans all chips with exact
coupling. Sections may have DIFFERENT topologies (the production case —
per-section material masks mesh differently): every section pads to the
window's pow2-bucketed max (V, T) with inert elements (zero-multiplier
copies of element 0, masked padding vertices), so one jitted program
serves ragged stacks.

Numerics: the system is built in DISPLACEMENT FORM — per-section LOCAL
rest coordinates (tile-sized), the start displacement u = pos - verts0
(small), and the per-link-point REST residual (a few px). All carried
magnitudes are small, so f32 device math keeps sub-0.001 px resolution
regardless of the stack's world extent; world positions reassemble on the
host in f64 at commit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from feabas_tpu.ops import fem


def _pow2(n, lo=8):
    return max(lo, 1 << int(max(n, 1) - 1).bit_length())


def build_stack_system(meshes, links_per_pair, pow2_bucket=True):
    """Pack S meshes + neighbor links into padded batched arrays.

    Args:
        meshes: list of S Mesh objects; topologies MAY differ (ragged
            stacks pad to the max (V, T), pow2-bucketed so the jitted
            solve is reused across windows).
        links_per_pair: list of S-1 dicts with keys idx0, bary0, idx1,
            bary1, weight — section-local vertex indices linking z to
            z+1 (weight-0 rows are inert).
    Returns a dict of batched numpy arrays ready for sharding, in
    displacement form (see module docstring). Uses INITIAL as the shape
    gear and MOVING as the start gear.
    """
    from feabas_tpu import constant as const
    return _build_system(meshes, links_per_pair,
                         shape_gear=const.MESH_GEAR_INITIAL,
                         start_gear=const.MESH_GEAR_MOVING,
                         pow2_bucket=pow2_bucket)


def _build_system(meshes, links_per_pair, shape_gear, start_gear,
                  pow2_bucket=True):
    S = len(meshes)
    nvs = [m.num_vertices for m in meshes]
    nts = [m.triangles.shape[0] for m in meshes]
    # UNIFORM stacks (the common case: one meshing config) carry no
    # padding at all — pow2 bucketing only pays when topologies differ
    # (each padded element/vertex is wasted FLOPs every CG iteration)
    ragged = (len(set(nvs)) > 1 or len(set(nts)) > 1
              or any(not np.array_equal(m.triangles, meshes[0].triangles)
                     for m in meshes[1:]))
    V = _pow2(max(nvs)) if (pow2_bucket and ragged) else max(nvs)
    T = _pow2(max(nts)) if (pow2_bucket and ragged) else max(nts)
    tris = np.zeros((S, T, 3), np.int32)
    verts0_local = np.zeros((S, V, 2), np.float64)
    u = np.zeros((S, V, 2), np.float64)
    mult = np.zeros((S, T), np.float64)
    poisson = np.zeros((S, T), np.float64)
    free = np.zeros((S, V, 1), np.float32)
    verts0_host = []
    for k, m in enumerate(meshes):
        nv, nt = nvs[k], nts[k]
        v0 = m.vertices_w_offset(shape_gear)
        pos = m.vertices_w_offset(start_gear)
        verts0_host.append(v0)
        c = v0.mean(axis=0)
        verts0_local[k, :nv] = v0 - c
        # padding vertices sit at the section center (valid coords)
        u[k, :nv] = pos - v0
        tr = m.triangles
        tris[k, :nt] = tr
        # pad with inert copies of element 0: valid shape matrices,
        # multiplier 0 -> Ke = 0 (degenerate padding would produce NaNs)
        tris[k, nt:] = tr[0]
        groups = m.element_arrays(gear=shape_gear)
        mult[k, :nt] = np.concatenate([g['multiplier'] for g in groups])
        poisson[k, :nt] = np.concatenate([g['poisson'] for g in groups])
        if not m.locked:
            free[k, :nv, 0] = 1.0
    # links: pad per-pair to a common pow2 length
    L = max((l['weight'].shape[0] for l in links_per_pair), default=0)
    L = _pow2(L) if pow2_bucket else max(L, 1)
    idx0 = np.zeros((max(S - 1, 1), L, 3), np.int32)
    bary0 = np.zeros((max(S - 1, 1), L, 3), np.float32)
    idx1 = np.zeros((max(S - 1, 1), L, 3), np.int32)
    bary1 = np.zeros((max(S - 1, 1), L, 3), np.float32)
    weight = np.zeros((max(S - 1, 1), L), np.float32)
    r_rest = np.zeros((max(S - 1, 1), L, 2), np.float64)
    for k, l in enumerate(links_per_pair):
        n = l['weight'].shape[0]
        idx0[k, :n] = l['idx0']
        bary0[k, :n] = l['bary0']
        idx1[k, :n] = l['idx1']
        bary1[k, :n] = l['bary1']
        weight[k, :n] = l['weight']
        if n:
            p0r = (verts0_host[k][np.asarray(l['idx0'])]
                   * np.asarray(l['bary0'], np.float64)[..., None]).sum(1)
            p1r = (verts0_host[k + 1][np.asarray(l['idx1'])]
                   * np.asarray(l['bary1'], np.float64)[..., None]).sum(1)
            r_rest[k, :n] = p1r - p0r
    system = {
        # uniform stacks share ONE (T,3) triangle table (lets XLA hoist
        # the topology out of the section vmap — measured 2.5x on the
        # per-iteration cost); ragged stacks carry per-section tables
        'tris': tris[0] if not ragged else tris,
        'verts0': verts0_local.astype(np.float32),
        'u': u.astype(np.float32),
        'r_rest': r_rest.astype(np.float32),
        'multiplier': mult.astype(np.float32),
        'poisson': poisson.astype(np.float32),
        'links': (idx0, bary0, idx1, bary1, weight),
        'free': free,
        'verts0_host': verts0_host,
        'num_vertices': nvs,
    }
    if not ragged:
        _lattice_pack(system, meshes[0], shape_gear)
    return system


def _lattice_pack(system, mesh0, shape_gear):
    """Re-index a uniform stack onto its vertex lattice when the shared
    topology embeds (fem.lattice_embedding): vertices pack in row-major
    (ny, nx) cell order so ``stack_solve(grid_shape=...)`` can run the
    9-plane stencil matvec instead of gather/scatter FEM transposes.
    Unoccupied cells (staggered-boundary holes) become inert padding
    (free 0, no element references). No-op (gather fallback) when the
    mesh is not a lattice. The packing is exact for the gather path too
    — callers that ignore ``grid_shape`` see an equivalent system."""
    emb = fem.lattice_embedding(
        mesh0.vertices_w_offset(shape_gear), np.asarray(system['tris']))
    if emb is None:
        return
    cell_of, (ny, nx) = emb
    Vg = ny * nx
    S = system['u'].shape[0]
    nv = cell_of.shape[0]

    def pack_rows(a, fill=0.0):
        out = np.full((S, Vg) + a.shape[2:], fill, a.dtype)
        out[:, cell_of] = a[:, :nv]
        return out

    system['verts0'] = pack_rows(system['verts0'])
    system['u'] = pack_rows(system['u'])
    system['free'] = pack_rows(system['free'])
    system['tris'] = cell_of[np.asarray(system['tris'])].astype(np.int32)
    idx0, bary0, idx1, bary1, weight = system['links']
    system['links'] = (cell_of[idx0].astype(np.int32), bary0,
                       cell_of[idx1].astype(np.int32), bary1, weight)
    vh = []
    for v0 in system['verts0_host']:
        out = np.zeros((Vg, 2), v0.dtype)
        out[cell_of] = v0[:nv]
        vh.append(out)
    system['verts0_host'] = vh
    system['num_vertices'] = [Vg] * S
    # real-vertex mask: rigid modes and residue passes must skip holes
    rm = np.zeros(Vg, bool)
    rm[cell_of] = True
    system['real_mask'] = rm
    system['vertex_map'] = cell_of          # original vertex -> cell
    system['grid_shape'] = (ny, nx)
    # topology-static assembly transpose: the in-program scatter-add
    # assembly serializes on duplicate destinations (seconds of fixed
    # cost per solve at production stack sizes) — gather tables instead
    system['sten'] = fem.build_stencil_assembly(
        np.asarray(system['tris']), nx, Vg)


def stack_rigid_modes(system):
    """Orthonormal rigid modes (tx, ty, infinitesimal rotation about the
    component centroid) of every fully-free chain component of a stacked
    window system, as (K, S, V, 2), or None when every component contains
    a locked section. Same role as ``SLM._rigid_deflation_modes``
    (reference extra-DOF removal, optimizer.py:1362-1377): a window with
    no locked seed would otherwise buy residue reduction with a spurious
    whole-window rotation whose only resistance is the rest-residual
    geometry. Mode support excludes padding vertices."""
    free = np.asarray(system['free'])                   # (S, V, 1)
    S, V = free.shape[0], free.shape[1]
    weight = np.asarray(system['links'][4])             # (S-1, L)
    nvs = system['num_vertices']
    verts0_host = system['verts0_host']
    # chain components: cut at pairs with no active links
    comp = np.zeros(S, np.int64)
    for k in range(1, S):
        comp[k] = comp[k - 1] + (0 if (k - 1 < weight.shape[0]
                                       and (weight[k - 1] > 0).any())
                                 else 1)
    sec_free = free.max(axis=(1, 2)) > 0
    from feabas_tpu.optimizer import rigid_modes_flat
    slot = np.arange(S * V).reshape(S, V)
    # lattice-packed systems: modes must skip unoccupied grid cells
    # (they carry no DOFs; support there would pollute the deflation)
    rmask = system.get('real_mask')
    comps = []
    for lbl in np.unique(comp):
        sel = np.nonzero(comp == lbl)[0]
        if not sec_free[sel].all():
            continue
        if rmask is None:
            rows = np.concatenate([slot[s, :nvs[s]] for s in sel])
            q = np.concatenate([verts0_host[s][:nvs[s]] for s in sel])
        else:
            rows = np.concatenate([slot[s][rmask] for s in sel])
            q = np.concatenate([verts0_host[s][rmask] for s in sel])
        comps.append((rows, q))
    modes = rigid_modes_flat(S * V, comps)
    return None if modes is None else modes.reshape(-1, S, V, 2)


def _stack_matvec(x, Ke, tris, links, free, lam_s, inc=None, imask=None,
                  C=None, grid_shape=None, linc=None):
    """A @ x for the stacked system; x: (S, V, 2); tris: (S, T, 3). With
    an incidence table the FEM transpose uses gathers instead of
    duplicate-index scatter-adds. With stencil
    planes ``C`` (lattice-packed systems, fem.stencil_assemble) the FEM
    matvec runs gather-free as 9 shifted multiply-adds per section.
    With ``linc`` (build_link_transpose) the crosslink transpose runs as
    a touched-vertex incidence gather + unique-index scatter instead of
    the duplicate-index scatter-add."""
    x = x * free
    shared = tris.ndim == 2          # one topology for every section
    if inc is not None and (inc.ndim == 2) != shared:
        # a 2D (shared) incidence table cannot pair with ragged
        # per-section tris, nor a 3D table with a shared topology —
        # silent fallback would mis-gather or drop the optimization
        raise ValueError(f'incidence table rank {inc.ndim} does not match '
                         f'{"shared" if shared else "per-section"} tris')
    if C is not None:
        ny, nx = grid_shape
        y = jax.vmap(lambda xi, Ci: fem.stiffness_matvec_stencil(
            xi, Ci, ny, nx))(x, C) * lam_s
    elif inc is not None and inc.ndim == 2 and shared:
        # shared incidence table: one (V, D) table closed over by the
        # section vmap
        y = jax.vmap(lambda xi, Ki: fem.stiffness_matvec_gather(
            xi, Ki, tris, inc, imask))(x, Ke) * lam_s
    elif inc is not None and not shared:
        y = jax.vmap(lambda xi, Ki, tr, ic, im: fem.stiffness_matvec_gather(
            xi, Ki, tr, ic, im))(x, Ke, tris, inc, imask) * lam_s
    elif shared:
        y = jax.vmap(lambda xi, Ki: fem.stiffness_matvec(xi, Ki, tris))(
            x, Ke) * lam_s
    else:
        y = jax.vmap(lambda xi, Ki, tr: fem.stiffness_matvec(xi, Ki, tr))(
            x, Ke, tris) * lam_s
    idx0, bary0, idx1, bary1, weight = _pad_links_to_sections(
        links, x.shape[0])
    # link slot z couples section z (side0) and z+1 (side1); the padded
    # slot S-1 is inert (weight 0). Everything below is batched on the
    # SAME evenly-sharded z axis — under SPMD the only collective is the
    # one-section halo permute from the rolls. (The previous (S-1)-axis
    # slicing formulation made the partitioner all-gather the full
    # (S, V, 2) state 3x per CG iteration — measured in
    # tools/sharded_solve_study.py.)
    xn = jnp.roll(x, -1, axis=0)                 # section z+1 beside z
    p0 = jax.vmap(fem.link_eval)(x, idx0, bary0)
    p1 = jax.vmap(fem.link_eval)(xn, idx1, bary1)
    r = (p1 - p0) * (weight ** 2)[..., None]

    if linc is not None:
        tv, incl = linc
        S, L = weight.shape
        # flattened per-section contribution rows [side0 | side1 rolled
        # to its section | one zero row]; the roll halo is 3L rows —
        # smaller than the full-V y1 halo it replaces
        c0 = (-bary0[:, :, :, None] * r[:, :, None, :]).reshape(S, 3 * L, 2)
        c1 = (bary1[:, :, :, None] * r[:, :, None, :]).reshape(S, 3 * L, 2)
        cc = jnp.concatenate([c0, jnp.roll(c1, 1, axis=0),
                              jnp.zeros((S, 1, 2), c0.dtype)], axis=1)
        g = jax.vmap(lambda c, ic: c[ic].sum(axis=1))(cc, incl)
        y = y + jax.vmap(
            lambda yi, t, gi: jnp.zeros_like(yi).at[t].add(
                gi, unique_indices=True))(y, tv, g)
        return y * free

    def scatter(xi, idx, b, rr, sign):
        return jnp.zeros_like(xi).at[idx].add(sign * b[:, :, None] * rr[:, None, :])

    y0 = jax.vmap(lambda xi, idx, b, rr: scatter(xi, idx, b, rr, -1.0))(
        x, idx0, bary0, r)
    y1 = jax.vmap(lambda xi, idx, b, rr: scatter(xi, idx, b, rr, 1.0))(
        xn, idx1, bary1, r)
    y = y + y0 + jnp.roll(y1, 1, axis=0)
    return y * free


def build_link_transpose(links, S, V):
    """Host-side transpose tables for the crosslink scatter (once per
    system; topology-static, weight-independent).

    The naive ``zeros.at[idx].add`` transpose scatters with duplicate
    vertex indices. Instead: per section, gather each
    TOUCHED vertex's few contributions from the flattened per-iteration
    contribution array and place them with a UNIQUE-index scatter
    (padding rows target distinct unused vertices, so the scatter
    parallelizes).

    Returns (tv (S, P) int32 target vertices, inc (S, P, D) int32 rows
    into the (6L+1)-row per-section contribution array [side0 | rolled
    side1 | zero row]); P/D pow2-padded, pad entries point at the zero
    row.
    """
    idx0 = np.asarray(links[0])
    bar0 = np.asarray(links[1])
    idx1 = np.asarray(links[2])
    bar1 = np.asarray(links[3])
    L = idx0.shape[1]
    if idx0.shape[0] != S:                       # (S-1)-slot layout
        pad = np.zeros((1, L, 3), idx0.dtype)
        padb = np.zeros((1, L, 3), bar0.dtype)
        idx0 = np.concatenate([idx0, pad], axis=0)
        idx1 = np.concatenate([idx1, pad], axis=0)
        bar0 = np.concatenate([bar0, padb], axis=0)
        bar1 = np.concatenate([bar1, padb], axis=0)
    zero_row = 6 * L
    ent_v, ent_f, ent_s = [], [], []
    for z in range(S):
        # prune entries with a statically-zero barycentric weight: their
        # contribution is identically zero for EVERY weight pass (this
        # removes the inert padded link slots, whose all-zero idx rows
        # would otherwise pile hundreds of dead entries on vertex 0 and
        # explode the per-vertex table depth D)
        m0 = (bar0[z].ravel() != 0)
        ent_v.append(idx0[z].ravel()[m0])
        ent_f.append(np.arange(3 * L)[m0])
        ent_s.append(np.full(int(m0.sum()), z))
        zp = (z - 1) % S                         # side1 rolls +1
        m1 = (bar1[zp].ravel() != 0)
        ent_v.append(idx1[zp].ravel()[m1])
        ent_f.append(3 * L + np.arange(3 * L)[m1])
        ent_s.append(np.full(int(m1.sum()), z))
    ev = np.concatenate(ent_v)
    ef = np.concatenate(ent_f)
    es = np.concatenate(ent_s)
    if ev.size == 0:
        return None
    key = es.astype(np.int64) * V + ev
    order = np.argsort(key, kind='stable')
    key_s, ef_s = key[order], ef[order]
    uniq, starts = np.unique(key_s, return_index=True)
    counts = np.diff(np.append(starts, key_s.size))
    D = 1 << int(counts.max() - 1).bit_length()
    P_real = max(int(np.bincount(uniq // V, minlength=S).max()), 1)
    # pow2 bucket, capped at V: pad slots must each claim a DISTINCT
    # unused vertex, and touched <= V always
    P = min(1 << int(P_real - 1).bit_length(), V)
    tv = np.zeros((S, P), np.int32)
    inc = np.full((S, P, D), zero_row, np.int32)
    used = np.zeros((S, V), bool)
    used[uniq // V, uniq % V] = True
    slot = np.zeros(S, np.int64)
    for k in range(uniq.size):
        z, v = int(uniq[k] // V), int(uniq[k] % V)
        p = slot[z]
        tv[z, p] = v
        c = counts[k]
        inc[z, p, :c] = ef_s[starts[k]:starts[k] + c]
        slot[z] += 1
    # pad slots -> DISTINCT unused vertices (zero contributions), so the
    # device scatter can assert unique indices
    for z in range(S):
        n_pad = P - slot[z]
        if n_pad:
            free_ids = np.nonzero(~used[z])[0]
            if free_ids.size < n_pad:            # degenerate tiny mesh
                return None
            tv[z, slot[z]:] = free_ids[:n_pad]
    return tv, inc


def _pad_links_to_sections(links, S):
    """Normalize link arrays to a full-S leading axis (slot z couples
    sections z and z+1; the last slot is inert, weight 0) so the link
    axis shards exactly like the section axis. (S-1)-axis inputs — the
    ``build_stack_system`` layout — gain one zero row; already-padded
    inputs pass through."""
    if links[0].shape[0] == S:
        return links
    return tuple(jnp.concatenate(
        [a, jnp.zeros_like(a[:1])], axis=0) for a in links)


@functools.partial(jax.jit, static_argnames=('maxiter', 'grid_shape'))
def stack_solve(verts0, u, tris, multiplier, poisson, links, r_rest, free,
                lam_s=1.0, tol=1e-7, maxiter=500, inc=None, imask=None,
                modes=None, lam_ratio=None, grid_shape=None, linc=None,
                sten=None):
    """One window relaxation in displacement form.

    Returns (new_u (S, V, 2), n_it, res). Minimizes
    lam_s/2 u'Ku + 1/2 |W C p|^2 over free dofs (``free`` is a per-VERTEX
    mask (S, V, 1), so padded vertices of ragged stacks stay inert), CG
    under while_loop; all arrays may be sharded along the leading z axis.
    With ``lam_ratio`` given, ``lam_s`` is computed IN-PROGRAM from the
    stiffness/crosslink diagonal trace ratio (SLM._balance_lambdas
    semantics) — one dispatch instead of a separate balance program.
    With static ``grid_shape`` (lattice-packed uniform stacks,
    ``build_stack_system``'s ``system['grid_shape']``), the per-iteration
    FEM matvec runs as the gather-free 9-plane stencil
    (fem.stiffness_matvec_stencil) — assembly pays one scatter per solve
    and CG then streams coefficient planes.
    """
    # per-section element matrices (local work); ``tris`` is a shared
    # (T,3) table for uniform stacks or (S,T,3) per-section tables
    shared = tris.ndim == 2
    if shared:
        B, area2 = jax.vmap(lambda v0: fem.shape_matrices(v0[tris]))(verts0)
    else:
        B, area2 = jax.vmap(
            lambda v0, tr: fem.shape_matrices(v0[tr]))(verts0, tris)
    Ke = jax.vmap(fem.eng_element_stiffness)(B, area2, multiplier, poisson)
    dt = u.dtype
    r_rest = r_rest.astype(dt)
    C = None
    if grid_shape is not None and shared:
        if grid_shape[0] * grid_shape[1] != u.shape[1]:
            raise ValueError(f'grid_shape {grid_shape} does not tile '
                             f'V={u.shape[1]} vertices')
        if sten is not None:
            # host-built transpose table: gather + sum, no scatter
            # (the scatter assembly serializes on duplicate vertices —
            # seconds per solve at 80 x 25k-tri stacks)
            C = jax.vmap(lambda Ki: fem.stencil_assemble_gather(
                Ki, sten))(Ke)
        else:
            tgt = fem.stencil_targets(tris, grid_shape[1], u.shape[1])
            C = jax.vmap(lambda Ki: fem.stencil_assemble(
                Ki, tgt, u.shape[1]))(Ke)

    from feabas_tpu.optimizer import _mode_projector
    project = _mode_projector(None if modes is None else modes.astype(dt))

    def matvec(x):
        return project(_stack_matvec(project(x), Ke, tris, links, free,
                                     lam_s, inc=inc, imask=imask,
                                     C=C, grid_shape=grid_shape, linc=linc))

    # rhs = -(lam_s K u + C^T W r(pos)); r(pos) = r_rest + (U1 - U0).
    # Links normalize to the full-S axis (inert last slot) so every
    # batched op below shards evenly along z — see _stack_matvec.
    links = _pad_links_to_sections(links, u.shape[0])
    r_rest = _pad_links_to_sections((r_rest,), u.shape[0])[0]
    idx0, bary0, idx1, bary1, weight = links
    V = u.shape[1]
    if C is not None:
        dK = jax.vmap(lambda Ci: fem.stencil_diag(Ci, V))(C)
    elif shared:
        dK = jax.vmap(lambda Ki: fem.stiffness_diag(Ki, tris, V))(Ke)
    else:
        dK = jax.vmap(lambda Ki, tr: fem.stiffness_diag(Ki, tr, V))(Ke, tris)
    dC0 = jax.vmap(lambda idx, bb, w: jnp.zeros((V, 2), dt)
                   .at[idx].add((bb ** 2 * (w ** 2)[:, None])[:, :, None]
                                * jnp.ones((1, 1, 2), dt)))(idx0, bary0, weight)
    dC1 = jax.vmap(lambda idx, bb, w: jnp.zeros((V, 2), dt)
                   .at[idx].add((bb ** 2 * (w ** 2)[:, None])[:, :, None]
                                * jnp.ones((1, 1, 2), dt)))(idx1, bary1, weight)
    dC = dC0 + jnp.roll(dC1, 1, axis=0)
    if lam_ratio is not None:
        # in-program trace balance (matches _stack_lambda_balance)
        tr_c = jnp.sum(dC)
        tr_k = jnp.sum(jnp.where(dC != 0, dK, 0.0))
        ok = (tr_c > 0) & (tr_k > 0)
        lam_s = jnp.where(ok, lam_ratio * tr_c
                          / jnp.where(tr_k > 0, tr_k, 1.0), 1.0).astype(dt)
    if C is not None:
        b = -jax.vmap(lambda ui, Ci: fem.stiffness_matvec_stencil(
            ui, Ci, grid_shape[0], grid_shape[1]))(u, C) * lam_s
    elif shared:
        b = -jax.vmap(lambda ui, Ki: fem.stiffness_matvec(ui, Ki, tris))(
            u, Ke) * lam_s
    else:
        b = -jax.vmap(lambda ui, Ki, tr: fem.stiffness_matvec(ui, Ki, tr))(
            u, Ke, tris) * lam_s
    un = jnp.roll(u, -1, axis=0)
    U0 = jax.vmap(fem.link_eval)(u, idx0, bary0)
    U1 = jax.vmap(fem.link_eval)(un, idx1, bary1)
    r0 = (r_rest + U1 - U0) * (weight ** 2)[..., None]
    b = b + jax.vmap(
        lambda xi, idx, bb, rr: jnp.zeros_like(xi).at[idx].add(
            bb[:, :, None] * rr[:, None, :]))(u, idx0, bary0, r0)
    b = b + jnp.roll(jax.vmap(
        lambda xi, idx, bb, rr: jnp.zeros_like(xi).at[idx].add(
            -bb[:, :, None] * rr[:, None, :]))(un, idx1, bary1, r0),
        1, axis=0)
    b = b * free

    diag = dK * lam_s + dC
    diag = jnp.where(free > 0, diag, 1.0)

    # two-level preconditioner: the stiffness annihilates uniform
    # per-section translations exactly, so the chain's slow long-
    # wavelength modes live in an (S,S) tridiagonal coarse space built
    # from the crosslink weights alone — solve it exactly (dense inverse,
    # S is tiny) and add the correction to the Jacobi preconditioner
    # (the reference reaches for pyAMG here: feabas/optimizer.py:1969)
    S = u.shape[0]
    minv = jnp.where(diag > 1e-12, 1.0 / jnp.where(diag > 1e-12, diag, 1.0),
                     1.0)
    freed = free.max(axis=(1, 2))                       # (S,) section-free
    # per-PAIR crosslink weight: slot S-1 is the inert pad (weight 0)
    Wp = (weight ** 2).sum(axis=1)[:-1]                 # (S-1,)
    cdiag = jnp.zeros(S, dt).at[:-1].add(Wp).at[1:].add(Wp)
    Acm = (jnp.diag(cdiag) + jnp.diag(-Wp, 1) + jnp.diag(-Wp, -1))
    mask2 = freed[:, None] * freed[None, :]
    Acm = jnp.where(mask2 > 0, Acm, 0.0)
    reg = jnp.maximum(cdiag.max(), 1.0)
    Acm = Acm + jnp.diag(jnp.where(freed > 0, 1e-6 * reg, reg))
    Acinv = jnp.linalg.inv(Acm)

    def precond(r):
        rc = r.sum(axis=1)                              # (S, 2)
        cc = jnp.einsum('st,tc->sc', Acinv, rc,
                        precision=fem.MATMUL_PRECISION)
        cc = cc * freed[:, None]
        return project(r * minv + cc[:, None, :] * free)

    dx, n_it, res = fem.cg_solve(matvec, project(b), diag=diag, tol=tol,
                                 maxiter=maxiter, precond=precond)
    return u + project(dx) * free, n_it, res


def _put_global(arr, sharding):
    """Place a host array on a (possibly multi-host) sharding. Every
    process holds the full numpy system (host metadata is tiny relative to
    device work), so each process materializes exactly its addressable
    shards — the multi-host generalization of ``jax.device_put``."""
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def pad_stack_sections(system, multiple):
    """Append INERT sections so the section count divides the device
    mesh: repeated geometry with multiplier 0 (zero stiffness), no free
    DOFs, and zero-weight links — exact no-ops through matvec, rhs,
    preconditioner, and rigid-mode construction (padded components have
    no free vertices, so no modes). Lets the z-sharded solve run on ANY
    device count instead of requiring S %% n_devices == 0."""
    S = system['u'].shape[0]
    pad = (-S) % int(multiple)
    if pad == 0:
        return system
    out = dict(system)

    def rep_last(a):
        a = np.asarray(a)
        return np.concatenate([a] + [a[-1:]] * pad, axis=0)

    def zeros_like_rows(a):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

    out['verts0'] = rep_last(system['verts0'])
    out['u'] = rep_last(system['u'])
    out['poisson'] = rep_last(system['poisson'])
    out['multiplier'] = zeros_like_rows(system['multiplier'])
    out['free'] = zeros_like_rows(system['free'])
    if np.asarray(system['tris']).ndim == 3:
        out['tris'] = rep_last(system['tris'])
    # link slot k couples sections (k, k+1): grow to S'-1 slots; the new
    # slots carry weight 0 so pad sections never couple to anything
    out['links'] = tuple(zeros_like_rows(a) for a in system['links'])
    out['r_rest'] = zeros_like_rows(system['r_rest'])
    out['num_vertices'] = list(system['num_vertices']) + [0] * pad
    out['verts0_host'] = (list(system['verts0_host'])
                          + [system['verts0_host'][-1]] * pad)
    out.pop('linc', None)     # S-aligned; rebuild after padding
    return out


def shard_stack_system(system, device_mesh):
    """Place the batched arrays on a 1-D device mesh along z.

    Works for a single-process mesh AND a multi-process
    ``jax.distributed`` mesh spanning hosts: arrays are built with
    ``make_array_from_callback`` so only addressable shards materialize
    locally; the z-neighbor crosslink slicing in ``_stack_matvec`` then
    lowers to halo collectives between devices and hosts.
    Requires S %% n_devices == 0 — call :func:`pad_stack_sections`
    first for arbitrary section counts.
    """
    z = NamedSharding(device_mesh, P('z'))
    rep = NamedSharding(device_mesh, P())
    out = dict(system)
    for k in ('verts0', 'u', 'multiplier', 'poisson', 'free'):
        out[k] = _put_global(system[k], z)
    out['tris'] = _put_global(system['tris'],
                              z if np.asarray(system['tris']).ndim == 3
                              else rep)
    # links pad from S-1 to S slots (slot z couples sections z, z+1; the
    # added slot is inert, weight 0) so they shard on the SAME z axis as
    # the vertex arrays — replicated links made the SPMD partitioner
    # all-gather the full (S, V, 2) state 3x per CG iteration
    # (tools/sharded_solve_study.py); sharded links keep the crosslink
    # scatters shard-local with a one-section halo permute.
    S = system['u'].shape[0]

    def pad_link(a):
        a = np.asarray(a)
        if a.shape[0] == S:
            return a
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)],
                              axis=0)

    out['links'] = tuple(_put_global(pad_link(a), z)
                         for a in system['links'])
    out['r_rest'] = _put_global(pad_link(system['r_rest']), z)
    if system.get('linc') is not None:
        out['linc'] = tuple(_put_global(a, z) for a in system['linc'])
    if system.get('sten') is not None:
        out['sten'] = _put_global(system['sten'], rep)
    return out


def initialize_multihost(coordinator_address, num_processes, process_id,
                         **kwargs):
    """Join a multi-process JAX cluster. The multi-host replacement for
    the reference's dask/SLURM scale-out of window solves (reference:
    feabas/concurrent.py:147, aligner.py:909): one window's
    block-tridiagonal system spans every device of every host."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)


def global_stack_mesh():
    """1-D 'z' mesh over ALL devices of the cluster (all hosts)."""
    return JMesh(np.array(jax.devices()), ('z',))


def gather_stack_result(pos):
    """Full (S, V, 2) numpy result on every process."""
    if jax.process_count() == 1:
        return np.asarray(pos)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        pos, tiled=True))


def slm_window_to_stack(slm, shape_gear=None):
    """Pack an SLM window into the stacked z-chain form, or None.

    Packable when every material is linear ENG with no stiffness curve
    and every link couples z-neighbors — the standard case for serial-
    section alignment. Topologies MAY differ per section (production
    PSLG-meshed sections): the stack pads to the window's max (V, T)
    with inert elements. Returns the system dict built at ``shape_gear``
    (default FIXED, matching optimize_linear semantics).
    """
    from feabas_tpu import constant as const
    shape_gear = const.MESH_GEAR_FIXED if shape_gear is None else shape_gear
    meshes = slm.meshes
    if len(meshes) < 2 or not slm.is_linear:
        return None
    for m in meshes:
        for g in m.element_arrays(gear=shape_gear):
            if g['knots'] is not None:
                return None
    uid2idx = {m.uid: i for i, m in enumerate(meshes)}
    S = len(meshes)
    pair_links = {}
    for l in slm.active_links():
        i0, i1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
        if abs(i0 - i1) != 1:
            return None  # long-range anchor: not a pure z-chain
        k = min(i0, i1)
        flip = i0 > i1
        tid0, bary0 = l._tid0, l._bary0
        tid1, bary1 = l._tid1, l._bary1
        if flip:
            tid0, bary0, tid1, bary1 = tid1, bary1, tid0, bary0
            m_lo, m_hi = meshes[i1], meshes[i0]
        else:
            m_lo, m_hi = meshes[i0], meshes[i1]
        ent = pair_links.setdefault(k, {'idx0': [], 'bary0': [], 'idx1': [],
                                        'bary1': [], 'weight': []})
        ent['idx0'].append(m_lo.triangles[tid0])
        ent['bary0'].append(bary0)
        ent['idx1'].append(m_hi.triangles[tid1])
        ent['bary1'].append(bary1)
        ent['weight'].append(l.weight())
    links_per_pair = []
    for k in range(S - 1):
        ent = pair_links.get(k)
        if ent is None:
            links_per_pair.append({
                'idx0': np.zeros((0, 3), np.int32),
                'bary0': np.zeros((0, 3), np.float32),
                'idx1': np.zeros((0, 3), np.int32),
                'bary1': np.zeros((0, 3), np.float32),
                'weight': np.zeros(0, np.float32)})
        else:
            links_per_pair.append(
                {kk: np.concatenate(vv) for kk, vv in ent.items()})
    from feabas_tpu import constant as const
    return _build_system(meshes, links_per_pair, shape_gear=shape_gear,
                         start_gear=const.MESH_GEAR_MOVING)


def multihost_window_solve(meshes, links_per_pair, lam_s=1.0, tol=1e-7,
                           maxiter=500):
    """Solve one window across every device of a (multi-host) cluster.

    Builds the stacked system on host, pads the section axis to the
    global device count (inert sections), shards it over the 'z' mesh,
    runs the jitted CG (collectives within a host and across hosts), and
    returns (positions, n_it, res) with the full
    world-frame f64 solution on every process.
    """
    if len(meshes) < 2:
        raise ValueError('multihost_window_solve needs >= 2 sections')
    system = build_stack_system(meshes, links_per_pair)
    jmesh = global_stack_mesh()
    system = pad_stack_sections(system, jmesh.devices.size)
    system['linc'] = build_link_transpose(
        system['links'], system['u'].shape[0], system['u'].shape[1])
    sharded = shard_stack_system(system, jmesh)
    modes = stack_rigid_modes(system)
    if modes is not None:
        modes = _put_global(modes.astype(np.float32),
                            NamedSharding(jmesh, P()))
    u_new, n_it, res = stack_solve(
        sharded['verts0'], sharded['u'], sharded['tris'],
        sharded['multiplier'], sharded['poisson'], sharded['links'],
        sharded['r_rest'], sharded['free'], lam_s=lam_s, tol=tol,
        maxiter=maxiter, modes=modes,
        grid_shape=system.get('grid_shape'), linc=sharded.get('linc'),
        sten=sharded.get('sten'))
    u_all = gather_stack_result(u_new)
    pos = stack_positions(system, u_all)[:len(meshes)]  # drop pad sections
    return pos, int(n_it), float(res)


def stack_positions(system, u):
    """World-frame f64 positions per section from a solved displacement
    stack: list of (V_i, 2) arrays (unpadded). Lattice-packed systems
    (``vertex_map`` present) de-permute back to each mesh's original
    vertex order."""
    vm = system.get('vertex_map')
    out = []
    for k, v0 in enumerate(system['verts0_host']):
        nv = system['num_vertices'][k]
        pos = v0[:nv] + np.asarray(u[k, :nv], np.float64)
        if vm is not None and nv:
            pos = pos[vm]
        out.append(pos)
    return out
