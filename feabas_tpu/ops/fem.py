"""Matrix-free finite-element kernels.

The global stiffness system of the reference (scipy sparse assembly +
minres/pyAMG, ``feabas/optimizer.py:1945``, element math
``feabas/material.py:134-309``) is recast as a matrix-free device operator:

    A·x = lambda_s * K(x) + C^T W C x

where ``K(x)`` gathers per-element displacement vectors, applies per-element
6x6 stiffness blocks with one batched einsum, and scatter-adds
back, and the crosslink term does the same over (vertex-index, barycentric,
weight) link arrays. No sparse matrix is ever formed; the system is solved
with Jacobi-preconditioned CG under ``lax.while_loop``.

Element conventions (derived independently; scaling matches the reference so
``stiffness_lambda`` configs transfer): per-element DOF vector
``uv = [u1,v1,u2,v2,u3,v3]``; ``B`` (4x6) maps ``uv`` to the flattened
displacement gradient ``[du/dx, du/dy, dv/dx, dv/dy]``; element area factor
``area2 = 2*area``; K_e = area2 * (Bn B)^T D (Bn B).

Every contraction runs at ``constant.MATMUL_PRECISION``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from feabas_tpu.constant import MATMUL_PRECISION

_einsum = functools.partial(jnp.einsum, precision=MATMUL_PRECISION)


# Voigt selector: [du/dx, dv/dy, du/dy + dv/dx] from the flat gradient
_VOIGT = np.array([[1, 0, 0, 0],
                   [0, 0, 0, 1],
                   [0, 1, 1, 0]], dtype=np.float32)
# flat(F^-T) = U @ flat(F) / det(F)
_ADJT = np.array([[0, 0, 0, 1],
                  [0, 0, -1, 0],
                  [0, -1, 0, 0],
                  [1, 0, 0, 0]], dtype=np.float32)


def shape_matrices(tripts):
    """Per-element gradient operator.

    Args:
        tripts: (NT, 3, 2) resting-state triangle vertex coordinates.
    Returns:
        B: (NT, 4, 6) with B @ uv = [du/dx, du/dy, dv/dx, dv/dy].
        area2: (NT,) twice the signed area (abs).
    """
    tripts = jnp.asarray(tripts)
    e = jnp.roll(tripts, -1, axis=1) - jnp.roll(tripts, 1, axis=1)  # edge opp. each vtx
    area2 = jnp.abs(e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0])
    gx = e[:, :, 1] / area2[:, None]          # dN_i/dx
    gy = -e[:, :, 0] / area2[:, None]         # dN_i/dy
    nt = tripts.shape[0]
    B = jnp.zeros((nt, 4, 6), dtype=tripts.dtype)
    B = B.at[:, 0, 0::2].set(gx)
    B = B.at[:, 1, 0::2].set(gy)
    B = B.at[:, 2, 1::2].set(gx)
    B = B.at[:, 3, 1::2].set(gy)
    return B, area2


def _dmat(poisson, dtype):
    """Plane-stress-like elasticity matrix, unit modulus: (NT,3,3)."""
    nu = jnp.asarray(poisson)
    nt = nu.shape[0]
    D = jnp.zeros((nt, 3, 3), dtype=dtype)
    D = D.at[:, 0, 0].set(1.0)
    D = D.at[:, 1, 1].set(1.0)
    D = D.at[:, 0, 1].set(nu)
    D = D.at[:, 1, 0].set(nu)
    D = D.at[:, 2, 2].set((1.0 - nu) / 2.0)
    return D


def eng_element_stiffness(B, area2, multiplier, poisson):
    """Linear engineering-strain element stiffness (NT,6,6)."""
    Bn = _einsum('ij,njk->nik', jnp.asarray(_VOIGT, B.dtype), B)
    D = _dmat(poisson, B.dtype)
    K = _einsum('nji,njk,nkl->nil', Bn, D, Bn)
    return K * (area2 * multiplier)[:, None, None]


def deformation_gradient(B, uv):
    """flat F = B@uv + flat(I): (NT,4) = [F11,F12,F21,F22]."""
    F = _einsum('nij,nj->ni', B, uv)
    return F + jnp.asarray([1.0, 0.0, 0.0, 1.0], B.dtype)


def area_stretch(B, uv):
    F = deformation_gradient(B, uv)
    return F[:, 0] * F[:, 3] - F[:, 1] * F[:, 2]


def eng_element_stress(Ke, uv):
    return _einsum('nij,nj->ni', Ke, uv)


def svk_element(B, area2, uv, multiplier, poisson):
    """St. Venant-Kirchhoff tangent stiffness + internal force.

    Returns (Ke (NT,6,6), Pe (NT,6)). At uv=0 the tangent equals the linear
    engineering stiffness (used as a test invariant).
    """
    dtype = B.dtype
    F = deformation_gradient(B, uv)           # [F11,F12,F21,F22]
    F11, F12, F21, F22 = F[:, 0], F[:, 1], F[:, 2], F[:, 3]
    # Green strain, Voigt [E11, E22, 2E12]
    E11 = 0.5 * (F11 * F11 + F21 * F21 - 1.0)
    E22 = 0.5 * (F12 * F12 + F22 * F22 - 1.0)
    E12x2 = F11 * F12 + F21 * F22
    Ev = jnp.stack([E11, E22, E12x2], axis=-1)[..., None]     # (NT,3,1)
    D = _dmat(poisson, dtype)
    S = _einsum('nij,njk->nik', D, Ev)[:, :, 0]            # (NT,3) [S11,S22,S12]
    # BN: dE_voigt = BN @ duv; rows from dE = sym(F^T dF)
    zero = jnp.zeros_like(F11)
    AF = jnp.stack([
        jnp.stack([F11, zero, F21, zero], -1),
        jnp.stack([zero, F12, zero, F22], -1),
        jnp.stack([F12, F11, F22, F21], -1),
    ], axis=1)                                                # (NT,3,4)
    BN = _einsum('nij,njk->nik', AF, B)                    # (NT,3,6)
    # geometric stiffness: block-diag [[S11,S12],[S12,S22]] per component
    S11, S22, S12 = S[:, 0], S[:, 1], S[:, 2]
    Sg = jnp.zeros((F.shape[0], 4, 4), dtype=dtype)
    Sg = Sg.at[:, 0, 0].set(S11).at[:, 1, 1].set(S22)
    Sg = Sg.at[:, 2, 2].set(S11).at[:, 3, 3].set(S22)
    Sg = Sg.at[:, 0, 1].set(S12).at[:, 1, 0].set(S12)
    Sg = Sg.at[:, 2, 3].set(S12).at[:, 3, 2].set(S12)
    Kmat = _einsum('nji,njk,nkl->nil', BN, D, BN)
    Kgeo = _einsum('nji,njk,nkl->nil', B, Sg, B)
    scale = (area2 * multiplier)[:, None, None]
    Ke = (Kmat + Kgeo) * scale
    Pe = _einsum('nji,nj->ni', BN, S) * (area2 * multiplier)[:, None]
    return Ke, Pe


def nhk_element(B, area2, uv, multiplier):
    """Neo-Hookean (mu-only, psi = mu/2 (I1 - 2 - 2 ln J)) tangent + force."""
    dtype = B.dtype
    F = deformation_gradient(B, uv)
    J = F[:, 0] * F[:, 3] - F[:, 1] * F[:, 2]
    U = jnp.asarray(_ADJT, dtype)
    Fu = _einsum('ij,nj->ni', U, F)        # flat adj(F)^T = J * flat(F^-T)
    # P_flat = mu (F - F^-T) = mu (F - Fu/J)
    Pf = F - Fu / J[:, None]
    # dP/dF = mu (I - U/J + (Fu Fu^T)/J^2)
    I4 = jnp.eye(4, dtype=dtype)
    dPdF = (I4[None] - U[None] / J[:, None, None]
            + Fu[:, :, None] * Fu[:, None, :] / (J ** 2)[:, None, None])
    scale = 0.5 * area2 * multiplier
    Ke = _einsum('nji,njk,nkl->nil', B, dPdF, B) * scale[:, None, None]
    Pe = _einsum('nji,nj->ni', B, Pf) * scale[:, None]
    return Ke, Pe


def stiffness_curve_multiplier(J, knots_x, knots_y):
    """Per-element nonlinear stiffness factor from a sampled curve."""
    return jnp.interp(J, knots_x, knots_y, left=knots_y[0], right=knots_y[-1])


# ------------------------- gather / scatter ------------------------- #

def gather_uv(x, tris):
    """x: (NV,2) -> per-element (NT,6) [u1,v1,u2,v2,u3,v3]."""
    return x[tris].reshape(tris.shape[0], 6)


def scatter_uv(y_e, tris, nv):
    """(NT,6) element contributions -> (NV,2) via scatter-add."""
    return jnp.zeros((nv, 2), dtype=y_e.dtype).at[tris].add(
        y_e.reshape(-1, 3, 2))


def stiffness_matvec(x, Ke, tris):
    """K @ x for (NV,2) x."""
    uv = gather_uv(x, tris)
    y = _einsum('nij,nj->ni', Ke, uv)
    return scatter_uv(y, tris, x.shape[0])


def stiffness_diag(Ke, tris, nv):
    d = jnp.diagonal(Ke, axis1=1, axis2=2)     # (NT,6)
    return scatter_uv(d, tris, nv)


def stiffness_force(x, Ke, tris):
    """Internal force vector for linear elements (= K x)."""
    return stiffness_matvec(x, Ke, tris)


def build_incidence(tris, nv, max_degree=None):
    """Vertex->element-corner incidence table (host, once per topology).

    Inverting the map turns the FEM transpose-scatter (a scatter-add
    with duplicate indices) into a dense gather: for vertex v,
    ``inc[v, d]`` indexes the flattened (NT*3) per-corner contribution
    array, ``mask[v, d]`` zeroes padding. Returns (inc int32 (NV, D),
    mask float32 (NV, D))."""
    tris = np.asarray(tris)
    nt = tris.shape[0]
    flat_v = tris.ravel()                    # corner k of element t -> vertex
    order = np.argsort(flat_v, kind='stable')
    sorted_v = flat_v[order]
    counts = np.bincount(flat_v, minlength=nv)
    D = int(max_degree or (counts.max() if counts.size else 1))
    inc = np.zeros((nv, D), np.int32)
    mask = np.zeros((nv, D), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_group = np.arange(flat_v.size) - starts[sorted_v]
    keep = pos_in_group < D
    inc[sorted_v[keep], pos_in_group[keep]] = order[keep].astype(np.int32)
    mask[sorted_v[keep], pos_in_group[keep]] = 1.0
    return inc, mask


def gather_scatter_uv(y_e, inc, mask):
    """(NT,6) element contributions -> (NV,2) via incidence gather
    (scatter-free transpose)."""
    contrib = y_e.reshape(-1, 2)             # (NT*3, 2) per-corner vectors
    g = contrib[inc]                         # (NV, D, 2)
    return (g * mask[..., None]).sum(axis=1)


def stiffness_matvec_gather(x, Ke, tris, inc, mask):
    """K @ x using the incidence gather instead of scatter-add."""
    uv = gather_uv(x, tris)
    y = _einsum('nij,nj->ni', Ke, uv)
    return gather_scatter_uv(y, inc, mask)



# ------------------------- lattice stencil ------------------------- #
# The meshes this framework actually optimizes are LATTICES — cartesian
# grids with alternating diagonals (triangulation.cartesian_mesh) and
# equilateral row-staggered grids (triangulation.triangulate_geometry) —
# so K admits a 9-point stencil on the vertex lattice: per vertex, one
# 2x2 block per {-1,0,1}^2 neighbor offset. The matvec then runs as 9
# shifted multiply-adds with ZERO random accesses per CG iteration
# (one assembly per SOLVE), unlike the gather/scatter formulations
# above, which pay several random accesses per element per iteration.
# (Reference role: the assembled scipy CSR matvec inside minres,
# feabas/optimizer.py:1945-1968.)

def lattice_embedding(verts, tris, min_occupancy=0.5):
    """Integer lattice embedding of a mesh (host, once per topology).

    Returns (cell_of (NV,) int64 row-major cell ids, (ny, nx)) such that
    every triangle's vertex-pair offsets lie in {-1,0,1}^2 and no two
    vertices share a cell — or None when the mesh is not
    lattice-structured (border-refined tile meshes, fold-incised or
    PSLG meshes fall back to the gather matvec). Validation is purely
    combinatorial, so whenever this returns, a stencil matvec built on
    it is EXACT (coefficients come from the true per-element Ke).

    Tries a linear two-vector basis (cartesian grids) and a staggered
    row layout (equilateral lattices: odd rows shifted half a pitch).
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris)
    nv = verts.shape[0]
    if nv < 16 or tris.shape[0] < 8:
        return None

    def validate(pos):
        pos = pos - pos.min(axis=0)
        ny = int(pos[:, 1].max()) + 1
        nx = int(pos[:, 0].max()) + 1
        if ny < 2 or nx < 2 or nv < min_occupancy * ny * nx:
            return None
        off = pos[tris] - pos[tris[:, :1]]
        d01 = pos[tris[:, 1]] - pos[tris[:, 0]]
        d12 = pos[tris[:, 2]] - pos[tris[:, 1]]
        if max(np.abs(d01).max(), np.abs(d12).max(),
               np.abs(off).max()) > 1:
            return None
        cells = pos[:, 1] * nx + pos[:, 0]
        if np.unique(cells).size != nv:
            return None
        return cells.astype(np.int64), (ny, nx)

    # edge vectors, sign-normalized, clustered at 1/4-px resolution
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    d = verts[e[:, 1]] - verts[e[:, 0]]
    flip = (d[:, 1] < 0) | ((d[:, 1] == 0) & (d[:, 0] < 0))
    d = np.where(flip[:, None], -d, d)
    key = np.round(d * 4).astype(np.int64)
    uniq, counts = np.unique(key, axis=0, return_counts=True)
    cand = uniq[np.argsort(-counts)][:6] / 4.0
    ref = verts[0]

    # 1) linear basis: vertices at ref + E @ (i, j)
    for a in range(len(cand)):
        for b in range(a + 1, len(cand)):
            E = np.stack([cand[a], cand[b]], axis=1)
            det = np.linalg.det(E)
            scale = np.linalg.norm(cand[a]) * np.linalg.norm(cand[b])
            if abs(det) < 0.1 * max(scale, 1e-12):
                continue
            q = np.linalg.solve(E, (verts - ref).T).T
            p = np.round(q)
            if np.abs(q - p).max() > 0.25:
                continue
            out = validate(p.astype(np.int64))
            if out is not None:
                return out
    # 2) staggered rows: pitch a along x, row height h, odd rows +a/2
    horiz = cand[(np.abs(cand[:, 1]) < 0.25) & (np.abs(cand[:, 0]) > 0.25)]
    diag = cand[np.abs(cand[:, 1]) > 0.25]
    if len(horiz) and len(diag):
        a = abs(horiz[0, 0])
        h = abs(diag[0, 1])
        row_f = (verts[:, 1] - ref[1]) / h
        row = np.round(row_f)
        if np.abs(row_f - row).max() <= 0.25:
            for parity in (0, 1):
                col_f = (verts[:, 0] - ref[0]
                         - ((row.astype(np.int64) + parity) % 2) * a / 2) / a
                col = np.round(col_f)
                if np.abs(col_f - col).max() > 0.25:
                    continue
                out = validate(np.stack([col, row], -1).astype(np.int64))
                if out is not None:
                    return out
    # 2b) row-rank: group vertices into y-rows, columns by within-row
    # x-rank (every row left-aligned at col 0). Needs NO x rounding, so
    # it catches staggered lattices whose boundary columns sit at half
    # pitch (equilateral_bbox_mesh). Combinatorial validation decides.
    ys = np.sort(np.unique(verts[:, 1]))
    gaps = np.diff(ys)
    if gaps.size:
        h_est = np.median(gaps[gaps > gaps.max() * 0.5]) \
            if (gaps > gaps.max() * 0.5).any() else gaps.max()
        row_edges = np.nonzero(gaps > 0.4 * h_est)[0]
        row_of_y = np.zeros(ys.size, np.int64)
        row_of_y[row_edges + 1] = 1
        row_of_y = np.cumsum(row_of_y)
        row = row_of_y[np.searchsorted(ys, verts[:, 1])]
        order = np.lexsort((verts[:, 0], row))
        col = np.zeros(nv, np.int64)
        r_sorted = row[order]
        starts = np.searchsorted(r_sorted, np.arange(r_sorted.max() + 2))
        ranks = np.arange(nv) - starts[r_sorted]
        col[order] = ranks
        out = validate(np.stack([col, row], -1))
        if out is not None:
            return out
    # 3) graph propagation: per-edge offsets rounded in basis coords, BFS
    # along the edge graph (handles lattices whose BOUNDARY rows conform
    # to the ROI ring — triangulate_geometry output — where global
    # coordinate rounding collides). Validation stays combinatorial, so
    # an assignment that passes is exact no matter how it was reached.
    for a in range(len(cand)):
        for b in range(a + 1, len(cand)):
            E = np.stack([cand[a], cand[b]], axis=1)
            det = np.linalg.det(E)
            scale = np.linalg.norm(cand[a]) * np.linalg.norm(cand[b])
            if abs(det) < 0.1 * max(scale, 1e-12):
                continue
            out = _bfs_lattice(verts, tris, E, validate)
            if out is not None:
                return out
    return None


def _bfs_lattice(verts, tris, E, validate):
    """Assign integer lattice coords by propagating rounded per-edge
    basis offsets over a BFS spanning tree of the triangle edge graph;
    ``validate`` (combinatorial) decides correctness."""
    import collections
    nv = verts.shape[0]
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    d = verts[e[:, 1]] - verts[e[:, 0]]
    q = np.linalg.solve(E, d.T).T
    off = np.round(q).astype(np.int64)
    if np.abs(q - off).max() > 0.45 or np.abs(off).max() > 1:
        return None
    order = np.argsort(e[:, 0], kind='stable')
    starts = np.searchsorted(e[order, 0], np.arange(nv + 1))
    pos = np.zeros((nv, 2), np.int64)
    seen = np.zeros(nv, bool)
    seen[0] = True
    dq = collections.deque([0])
    n_seen = 1
    while dq:
        u = dq.popleft()
        for k in order[starts[u]:starts[u + 1]]:
            v = e[k, 1]
            if not seen[v]:
                seen[v] = True
                n_seen += 1
                pos[v] = pos[u] + off[k]
                dq.append(v)
    if n_seen != nv:
        return None                      # disconnected mesh
    return validate(pos)


def stencil_targets(tris, nx, nv):
    """(T,3,3) int32 flat scatter targets ``plane * nv + cell`` for the
    9-plane stencil assembly, from lattice-packed (row-major cell id)
    triangle tables. Pure index math — works on numpy or jnp arrays."""
    cx = tris % nx
    cy = tris // nx
    ox = cx[:, None, :] - cx[:, :, None]
    oy = cy[:, None, :] - cy[:, :, None]
    plane = (oy + 1) * 3 + (ox + 1)
    return plane * nv + tris[:, :, None]


def build_stencil_assembly(tris, nx, nv):
    """Host-side gather table for the 9-plane stencil assembly (once per
    topology). The in-program ``stencil_assemble`` scatter-add carries
    T*9 entries with heavy destination duplication (every vertex collects
    its ~6 incident elements). This table inverts it: for each (plane, vertex) destination, the rows
    of the flattened (T*9 + 1)-row element-block array that contribute
    (row t*9 + i*3 + j = element t's (i, j) 2x2 block; pad entries point
    at the trailing zero row). Assembly then = gather + sum, no scatter.

    Returns (9*nv, D) int32, D = max contributions per destination
    (<= vertex degree, ~6 on lattice meshes)."""
    tris = np.asarray(tris)
    T = tris.shape[0]
    tgt = np.asarray(stencil_targets(tris, nx, nv)).reshape(-1)
    order = np.argsort(tgt, kind='stable')
    st = tgt[order]
    counts = np.bincount(st, minlength=9 * nv)
    D = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rows = np.full((9 * nv, D), T * 9, np.int32)
    rows[st, np.arange(T * 9) - starts[st]] = order
    return rows


def stencil_assemble_gather(Ke, rows):
    """(T,6,6) element stiffness -> (9*nv, 2, 2) coefficient planes via
    a host-built transpose table (build_stencil_assembly) — the
    gather-based replacement for ``stencil_assemble``'s scatter (exact
    same result, pad rows read the zero block)."""
    T = Ke.shape[0]
    Kb = Ke.reshape(T, 3, 2, 3, 2).transpose(0, 1, 3, 2, 4).reshape(-1, 2, 2)
    Kb = jnp.concatenate([Kb, jnp.zeros((1, 2, 2), Ke.dtype)], axis=0)
    return Kb[rows].sum(axis=1)


def stencil_assemble(Ke, tgt, nv):
    """(T,6,6) element stiffness -> (9*nv, 2, 2) coefficient planes
    (plane k holds the 2x2 block coupling each vertex to its neighbor at
    offset (k%3-1, k//3-1)). ONE scatter-add per solve; CG iterations
    then stream the planes."""
    T = Ke.shape[0]
    Kb = Ke.reshape(T, 3, 2, 3, 2).transpose(0, 1, 3, 2, 4)
    return jnp.zeros((9 * nv, 2, 2), Ke.dtype).at[
        jnp.asarray(tgt).reshape(-1)].add(Kb.reshape(-1, 2, 2))


def stiffness_matvec_stencil(x, C, ny, nx):
    """K @ x as 9 shifted multiply-adds on the (ny, nx) vertex lattice —
    zero gathers/scatters per call. Off-grid neighbors carry zero
    coefficients (no element spans the boundary), so zero-padding is
    exact. Spelled as mul+sum (not dot_general): elementwise f32 math
    with no matmul precision to choose."""
    xg = x.reshape(ny, nx, 2)
    xp = jnp.pad(xg, ((1, 1), (1, 1), (0, 0)))
    Cg = C.reshape(9, ny, nx, 2, 2)
    out = jnp.zeros((ny, nx, 2), x.dtype)
    for k in range(9):
        oy, ox = k // 3 - 1, k % 3 - 1
        xs = xp[1 + oy:1 + oy + ny, 1 + ox:1 + ox + nx]
        out = out + (Cg[k] * xs[:, :, None, :]).sum(-1)
    return out.reshape(-1, 2)


def stencil_diag(C, nv):
    """Jacobi diagonal from the self-plane (plane 4) of the stencil:
    (nv, 2). Equals ``stiffness_diag`` exactly."""
    C4 = C.reshape(9, nv, 2, 2)[4]
    return jnp.stack([C4[:, 0, 0], C4[:, 1, 1]], axis=-1)


# ------------------------- crosslinks ------------------------- #
# A link couples a barycentric point on mesh A to one on mesh B (global
# vertex indexing): residual r_l = sum_i b1_i x[i1_i] - sum_i b0_i x[i0_i]
# + offset_l, weighted by w_l. (reference Link: feabas/optimizer.py:17-233)

def link_eval(x, idx, bary):
    """Barycentric sample of (NV,2) x at links: (L,2)."""
    return _einsum('lk,lkc->lc', bary, x[idx])


def link_residual(x, idx0, bary0, idx1, bary1, offset):
    return link_eval(x, idx1, bary1) - link_eval(x, idx0, bary0) + offset


def crosslink_matvec(x, idx0, bary0, idx1, bary1, weight):
    """(C^T W C) x with W = diag(weight^2) over both xy components."""
    r = link_eval(x, idx1, bary1) - link_eval(x, idx0, bary0)
    r = r * (weight ** 2)[:, None]
    out = jnp.zeros_like(x)
    out = out.at[idx1].add(bary1[:, :, None] * r[:, None, :])
    out = out.at[idx0].add(-bary0[:, :, None] * r[:, None, :])
    return out


def crosslink_rhs(x_current, idx0, bary0, idx1, bary1, weight, offset):
    """-C^T W r(x_current): RHS so that solving A dx = rhs reduces link
    residuals from the current configuration."""
    r = link_residual(x_current, idx0, bary0, idx1, bary1, offset)
    r = r * (weight ** 2)[:, None]
    out = jnp.zeros_like(x_current)
    out = out.at[idx1].add(-bary1[:, :, None] * r[:, None, :])
    out = out.at[idx0].add(bary0[:, :, None] * r[:, None, :])
    return out


def crosslink_diag(nv, idx0, bary0, idx1, bary1, weight, dtype=jnp.float32):
    """Diagonal of C^T W C. Exact when each link row holds distinct vertices
    (a triangle's corners) and the two sides index disjoint vertex ranges
    (two different meshes) — both always true for real links; used only as
    a Jacobi preconditioner otherwise."""
    # cast up front: scattering f64 values into an f32 buffer is a
    # FutureWarning today and an error in future JAX releases
    w2 = (weight.astype(dtype) ** 2)[:, None]
    b0 = bary0.astype(dtype)
    b1 = bary1.astype(dtype)
    d = jnp.zeros((nv, 2), dtype=dtype)
    d = d.at[idx1].add((b1 ** 2 * w2)[:, :, None] * jnp.ones((1, 1, 2), dtype))
    d = d.at[idx0].add((b0 ** 2 * w2)[:, :, None] * jnp.ones((1, 1, 2), dtype))
    return d


# ------------------------- PCG solver ------------------------- #

def cg_solve(matvec, b, diag=None, x0=None, tol=1e-7, atol=0.0, maxiter=1000,
             chances=None, precond=None):
    """Jacobi-preconditioned conjugate gradients with best-so-far tracking.

    matvec operates on (NV,2) arrays; ``diag`` is the operator diagonal for
    the preconditioner (entries <=0 are treated as 1). Termination:
    ||r|| <= max(tol*||b||, atol), iteration budget ``maxiter``, or —
    when ``chances`` is set — after that many consecutive iterations
    without residual improvement (the SLM_Callback cost-increase-chances
    early stop, reference feabas/optimizer.py:1881-1942; the wall-clock
    timeout is replaced by the iteration budget since the loop is one
    compiled XLA program). The returned x is the best-so-far iterate by
    residual norm, so a stalled or diverging tail never degrades the
    solution. Returns (x_best, iterations, best_residual_norm). Runs fully
    under jit via lax.while_loop (replaces scipy minres+pyAMG at reference
    feabas/optimizer.py:1945-2080).
    """
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if diag is None:
        minv = jnp.ones_like(b)
    else:
        minv = jnp.where(diag > 1e-12, 1.0 / jnp.where(diag > 1e-12, diag, 1.0), 1.0)
    if precond is None:
        def precond(r):
            return minv * r

    bnorm = jnp.linalg.norm(b)
    limit = jnp.maximum(tol * bnorm, atol)
    max_stall = maxiter + 1 if chances is None else int(chances)

    def dot(a, c):
        return jnp.vdot(a, c, precision=MATMUL_PRECISION)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    rn0 = jnp.linalg.norm(r0)

    def cond(state):
        x, r, p, rz, it, best_x, best_rn, stall = state
        return ((it < maxiter) & (jnp.linalg.norm(r) > limit)
                & (stall <= max_stall))

    def body(state):
        x, r, p, rz, it, best_x, best_rn, stall = state
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
        p = z + beta * p
        rn = jnp.linalg.norm(r)
        improved = rn < best_rn
        best_x = jnp.where(improved, x, best_x)
        best_rn = jnp.where(improved, rn, best_rn)
        stall = jnp.where(improved, 0, stall + 1)
        return (x, r, p, rz_new, it + 1, best_x, best_rn, stall)

    state = (x0, r0, p0, rz0, 0, x0, rn0, 0)
    x, r, p, rz, it, best_x, best_rn, stall = jax.lax.while_loop(
        cond, body, state)
    return best_x, it, best_rn
