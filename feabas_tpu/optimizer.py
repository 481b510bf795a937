"""Spring-linked-mesh optimization.

`Link` stores point correspondences between two meshes as (triangle,
barycentric) anchors; `SLM` bundles meshes + links and runs the solver
cascade: per-mesh translation LSQ -> greedy affine cascade -> global
elastic relaxation (linear or Newton-Raphson).

The elastic solve runs on the device: meshes concatenate into one global vertex
array, element stiffness blocks and crosslink operators act matrix-free
(``feabas_tpu.ops.fem``), and a Jacobi-PCG runs under jit. This replaces the
reference's scipy-sparse assembly + minres/pyAMG
(``feabas/optimizer.py:487-2080``); staging/gear semantics and the
lambda auto-balancing convention (negative lambda -> trace-ratio balance,
reference ``optimizer.py:1571``) are preserved so configs transfer.
"""

import functools
import os

import numpy as np
import scipy.sparse as sparse

import jax
import jax.numpy as jnp

from feabas_tpu import config
from feabas_tpu import constant as const
from feabas_tpu.constant import MATMUL_PRECISION
from feabas_tpu.ops import fem


def _sparse_spd_solve(A, b, diag, rtol=1e-10, maxiter=2000):
    """Solve the SPD sparse system A x = b (b may be (n, k)) with
    Jacobi-preconditioned CG; small systems go through a dense solve.
    Returns None on failure. Host-side helper for the translation solves,
    replacing O(n^2)-memory dense normal systems (ref lsqr role:
    optimizer.py:974-1047)."""
    n = A.shape[0]
    b = np.atleast_2d(np.asarray(b, np.float64))
    if b.shape[0] != n:
        b = b.T
    if n <= 256:
        try:
            return np.linalg.lstsq(A.toarray(), b, rcond=None)[0]
        except np.linalg.LinAlgError:
            return None
    from scipy.sparse.linalg import cg as sp_cg, lsqr as sp_lsqr
    M = sparse.diags(1.0 / np.maximum(diag, 1e-12))
    out = np.empty_like(b)
    for k in range(b.shape[1]):
        x, info = sp_cg(A, b[:, k], M=M, rtol=rtol, maxiter=maxiter)
        if info != 0:
            x = sp_lsqr(A, b[:, k], atol=rtol, btol=rtol)[0]
        out[:, k] = x
    return out


def _solver_dtype():
    """f64 when x64 is enabled (CPU validation), else f32 (device)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _solver_log():
    """Per-iteration solver observability (reference SLM_Callback logging,
    optimizer.py:1913-1942); DEBUG level so production runs stay quiet."""
    import logging as _logging
    return _logging.getLogger('feabas_tpu.solver')


def _flat_translation_precond(offsets_arr, agg, mesh_free, idx0, idx1,
                              weight, lam_c, diag, free, dtype):
    """Two-level preconditioner for the FLAT (mesh-concatenated) system:
    per-mesh uniform translations are exact stiffness null modes, so the
    slow CG modes live in the (M,M) crosslink Laplacian — invert it once
    per solve and add the correction to Jacobi. Segment sums use cumsum
    differences (vertices are mesh-ordered); the broadcast back is one
    NV gather. Returns a cg_solve ``precond`` callable or None."""
    M = mesh_free.shape[0]
    if M < 2 or M > 1024:
        return None
    m0 = jnp.searchsorted(offsets_arr, idx0[:, 0], side='right') - 1
    m1 = jnp.searchsorted(offsets_arr, idx1[:, 0], side='right') - 1
    w2 = (weight ** 2) * lam_c
    Ac = jnp.zeros((M, M), dtype)
    Ac = Ac.at[m0, m0].add(w2).at[m1, m1].add(w2)
    Ac = Ac.at[m0, m1].add(-w2).at[m1, m0].add(-w2)
    mask2 = mesh_free[:, None] * mesh_free[None, :]
    Ac = jnp.where(mask2 > 0, Ac, 0.0)
    reg = jnp.maximum(jnp.diagonal(Ac).max(), 1.0)
    Ac = Ac + jnp.diag(jnp.where(mesh_free > 0, 1e-6 * reg, reg))
    Acinv = jnp.linalg.inv(Ac)
    minv = jnp.where(diag > 1e-12,
                     1.0 / jnp.where(diag > 1e-12, diag, 1.0), 1.0)
    starts = offsets_arr[:-1]
    stops = offsets_arr[1:]

    def precond(r):
        cs = jnp.concatenate([jnp.zeros((1, 2), r.dtype),
                              jnp.cumsum(r, axis=0)])
        rc = cs[stops] - cs[starts]
        cc = jnp.einsum('st,tc->sc', Acinv, rc, precision=MATMUL_PRECISION)
        cc = cc * mesh_free[:, None]
        return r * minv + cc[agg] * free

    return precond


def _mode_projector(modes):
    """Orthogonal projector removing the span of ``modes`` — (K, ...) with
    any trailing layout matching the vectors it is applied to, an
    orthonormal set. Used to deflate the rigid-body modes of fully-free
    connected components: for such a component the infinitesimal-rotation
    direction has near-zero curvature (only the shape-gear anchor
    mismatches resist it) yet a nonzero gradient, so an unprojected
    linearized solve can 'pay' for residue with an arbitrarily large
    section rotation that the true nonlinear cost rejects (reference
    counterpart: extra-DOF removal for unlocked components,
    optimizer.py:1362-1377). Shared by the fused/general SLM solves, the
    sharded montage solve, and the stacked window solve. The
    contractions run at ``MATMUL_PRECISION``: a TF32 product would leak
    about 1e-3 of the rigid modes back in per projection."""
    if modes is None:
        return lambda x: x
    hi = MATMUL_PRECISION
    tail = tuple(range(1, modes.ndim))

    def project(x):
        # tensordot (not reshape+matmul): sharded operands keep their
        # layout and the cross-shard reduction lowers to one psum
        coef = jnp.tensordot(modes, x, axes=(tail, tuple(range(x.ndim))),
                             precision=hi)
        return x - jnp.tensordot(coef, modes, axes=((0,), (0,)),
                                 precision=hi)

    return project


def rigid_modes_flat(n_slots, components):
    """Orthonormal rigid modes (tx, ty, infinitesimal rotation about the
    component centroid) over a flattened (n_slots, 2) DOF layout.

    ``components``: iterable of (rows, q) — flat slot indices of one
    fully-free component and the matching world coordinates (len(rows),
    2). Returns (K, n_slots, 2) or None. This is the ONE construction
    behind SLM._rigid_deflation_modes, montage_rigid_modes, and
    stack_rigid_modes — the call sites differ only in how components are
    discovered and how slots map onto their array layouts."""
    modes = []
    for rows, q in components:
        rows = np.asarray(rows)
        if rows.size == 0:
            continue
        m1 = np.zeros((n_slots, 2))
        m1[rows, 0] = 1.0 / np.sqrt(rows.size)
        m2 = np.zeros((n_slots, 2))
        m2[rows, 1] = 1.0 / np.sqrt(rows.size)
        modes.extend([m1, m2])
        qc = np.asarray(q, np.float64) - np.asarray(q, np.float64).mean(axis=0)
        nrm = np.linalg.norm(qc)
        if nrm > 0:
            m3 = np.zeros((n_slots, 2))
            m3[rows, 0] = -qc[:, 1] / nrm
            m3[rows, 1] = qc[:, 0] / nrm
            modes.append(m3)
    if not modes:
        return None
    return np.stack(modes)


@functools.partial(jax.jit, static_argnames=('maxiter',))
def _linear_solve_eng(tris, B, area2, multiplier, poisson,
                      idx0, bary0, idx1, bary1, weight,
                      pos_start, pos_shape, free,
                      lam_ratio, tol, atol, maxiter,
                      offsets_arr=None, agg=None, mesh_free=None,
                      modes=None):
    """Fused elastic solve for the dominant case: linear-ENG elements only
    (any number of meshes/material groups, concatenated in global vertex
    numbering). Assembles element blocks, trace-balances the stiffness
    lambda, builds rhs/diag, and runs Jacobi-PCG — all in one XLA program
    so a solve costs one dispatch instead of ~15. Returns (NV+2, 2): dx rows followed by a stats block
    [[bnorm, res], [cost0, 0]]."""
    nv = pos_start.shape[0]
    Ke = fem.eng_element_stiffness(B, area2, multiplier, poisson)
    u_cur = pos_start - pos_shape
    # trace-ratio balance (reference optimizer.py:1571); lam_c is the unit
    # side of the ratio by convention
    dC = fem.crosslink_diag(nv, idx0, bary0, idx1, bary1, weight,
                            dtype=pos_start.dtype)
    dK = fem.stiffness_diag(Ke, tris, nv)
    tr_c = jnp.sum(dC)
    tr_k = jnp.sum(jnp.where(dC != 0, dK, 0.0))
    ok = (tr_c > 0) & (tr_k > 0)
    lam_s = jnp.where(ok, lam_ratio * tr_c / jnp.where(tr_k > 0, tr_k, 1.0), 1.0)
    lam_c = 1.0

    project = _mode_projector(modes)

    def matvec(x):
        x = project(x * free)
        y = fem.stiffness_matvec(x, Ke, tris) * lam_s
        y = y + fem.crosslink_matvec(x, idx0, bary0, idx1, bary1, weight) * lam_c
        return project(y * free)

    b = -fem.stiffness_matvec(u_cur, Ke, tris) * lam_s
    r0 = (fem.link_eval(pos_start, idx1, bary1)
          - fem.link_eval(pos_start, idx0, bary0))
    rw = r0 * (weight ** 2)[:, None]
    b = b.at[idx1].add(-bary1[:, :, None] * rw[:, None, :] * lam_c)
    b = b.at[idx0].add(bary0[:, :, None] * rw[:, None, :] * lam_c)
    b = project(b * free)
    diag = dK * lam_s + dC * lam_c
    diag = jnp.where(free > 0, diag, 1.0)
    precond = None
    if agg is not None:
        inner = _flat_translation_precond(
            offsets_arr, agg, mesh_free, idx0, idx1, weight, lam_c, diag,
            free, pos_start.dtype)
        if inner is not None:
            precond = lambda r: project(inner(project(r)))
    dx, n_it, res = fem.cg_solve(matvec, b, diag=diag, tol=tol, atol=atol,
                                 maxiter=maxiter, precond=precond)
    dx = project(dx)
    # pack (dx, bnorm, res, cost0) into ONE array so the caller pays a
    # single device->host round trip
    cost0 = jnp.linalg.norm(r0 * weight[:, None])
    stats = jnp.stack([jnp.stack([jnp.linalg.norm(b), res]),
                       jnp.stack([cost0, n_it.astype(dx.dtype)])])
    return jnp.concatenate([dx * free, stats.astype(dx.dtype)], axis=0)


class Link:
    """Point correspondences between two meshes (reference: optimizer.py:17).

    Anchors are (tid, barycentric) pairs on each mesh at the INITIAL gear,
    so they stay valid while vertices move. ``weight`` is the static match
    confidence; ``residue_weight`` is the multiplicative robust-damping
    factor updated between solves.
    """

    def __init__(self, mesh0, mesh1, tid0, bary0, tid1, bary1, weight=None,
                 name=None, strain=np.nan):
        self.meshes = (mesh0, mesh1)
        # scalar deformation proxy observed while matching (Match.strain);
        # feeds strain-driven per-mesh soft factors (ref aligner.py:713)
        self.strain = float(strain) if strain is not None else np.nan
        self._tid0 = np.asarray(tid0, dtype=np.int64)
        self._bary0 = np.asarray(bary0, dtype=np.float64)
        self._tid1 = np.asarray(tid1, dtype=np.int64)
        self._bary1 = np.asarray(bary1, dtype=np.float64)
        n = self._tid0.shape[0]
        self._weight = (np.ones(n) if weight is None
                        else np.asarray(weight, np.float64).ravel())
        self.residue_weight = np.ones(n)
        self._disabled = False
        self._name = name

    @classmethod
    def from_coordinates(cls, mesh0, mesh1, xy0, xy1, weight=None,
                         gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL),
                         **kwargs):
        xy0 = np.asarray(xy0, np.float64).reshape(-1, 2)
        xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
        # collision-aware point location: on folded meshes a match point
        # near the fold must anchor to the correct sheet (reference
        # trifinder arbitration: feabas/mesh.py:2080-2190)
        tmode = kwargs.pop('trifinder_mode', None)
        tmode0 = tmode if tmode is not None else (
            const.MESH_TRIFINDER_LEAST_DEFORM
            if mesh0.likely_collisions(gear[0]) else None)
        tmode1 = tmode if tmode is not None else (
            const.MESH_TRIFINDER_LEAST_DEFORM
            if mesh1.likely_collisions(gear[1]) else None)
        tid0 = mesh0.tri_finder(xy0, gear=gear[0], extrapolate=True,
                                mode=tmode0)
        tid1 = mesh1.tri_finder(xy1, gear=gear[1], extrapolate=True,
                                mode=tmode1)
        bary0 = mesh0.cart2bary(xy0, tid0, gear=gear[0])
        bary1 = mesh1.cart2bary(xy1, tid1, gear=gear[1])
        # points whose barycentric coordinates are wildly outside their
        # triangle were extrapolated too far; drop them
        ok = (np.abs(bary0).max(axis=-1) < 3) & (np.abs(bary1).max(axis=-1) < 3)
        if weight is not None:
            weight = np.asarray(weight, np.float64).ravel()[ok]
        return cls(mesh0, mesh1, tid0[ok], bary0[ok], tid1[ok], bary1[ok],
                   weight=weight, **kwargs)

    @property
    def name(self):
        if self._name is None:
            return f'{self.meshes[0].name or int(self.meshes[0].uid)}__to__' \
                   f'{self.meshes[1].name or int(self.meshes[1].uid)}'
        return self._name

    @property
    def num_matches(self):
        return 0 if self._disabled else self._tid0.shape[0]

    @property
    def uids(self):
        return (self.meshes[0].uid, self.meshes[1].uid)

    @property
    def disabled(self):
        return self._disabled

    def disable(self):
        self._disabled = True

    def enable(self):
        self._disabled = False

    def weight(self):
        return self._weight * self.residue_weight

    def xy0(self, gear=const.MESH_GEAR_MOVING):
        return self.meshes[0].bary2cart(self._tid0, self._bary0, gear=gear)

    def xy1(self, gear=const.MESH_GEAR_MOVING):
        return self.meshes[1].bary2cart(self._tid1, self._bary1, gear=gear)

    def dxy(self, gear=const.MESH_GEAR_MOVING):
        """Residual vectors xy1 - xy0 at a gear (world units)."""
        if isinstance(gear, (tuple, list)):
            g0, g1 = gear
        else:
            g0 = g1 = gear
        return self.xy1(gear=g1) - self.xy0(gear=g0)

    def residues(self, gear=const.MESH_GEAR_MOVING):
        return np.linalg.norm(self.dxy(gear=gear), axis=-1)

    def spacing(self):
        """Median nearest-neighbor spacing of the match lattice (INITIAL
        coords); scales the residue-smoothing kernel."""
        xy0 = self.xy0(gear=const.MESH_GEAR_INITIAL)
        if xy0.shape[0] < 2:
            return 1.0
        from scipy.spatial import cKDTree
        d, _ = cKDTree(xy0).query(xy0, k=2)
        return float(np.median(d[:, 1])) or 1.0

    def smooth_matrix(self, sigma=None):
        """Gaussian neighborhood-weight sparse matrix over the match
        lattice (reference smooth_matrix: optimizer.py:320-331); cached
        per sigma."""
        if sigma is None:
            sigma = 3.0 * self.spacing()
        cache = getattr(self, '_dis_smooth_matrix', None)
        if cache is None:
            cache = self._dis_smooth_matrix = {}
        if sigma not in cache:
            from scipy.spatial import cKDTree
            xy0 = self.xy0(gear=const.MESH_GEAR_INITIAL)
            n = xy0.shape[0]
            pairs = cKDTree(xy0).query_pairs(2.5 * sigma,
                                             output_type='ndarray')
            if pairs.size == 0:
                cache[sigma] = None
            else:
                w = np.exp(-np.sum((xy0[pairs[:, 0]] - xy0[pairs[:, 1]]) ** 2,
                                   axis=-1) / sigma ** 2)
                m = sparse.csr_matrix((w, (pairs[:, 0], pairs[:, 1])),
                                      shape=(n, n))
                cache[sigma] = m + m.T
        return cache[sigma]

    def dxy_smoothen(self, gear=const.MESH_GEAR_MOVING, sigma=None):
        """Weight-averaged residual vectors over each match's spatial
        neighborhood (reference dxy_smoothen: optimizer.py:334-350) —
        the locally COHERENT part of the residue field."""
        dxy = self.dxy(gear=gear)
        mtx = self.smooth_matrix(sigma=sigma)
        if mtx is None:
            return np.zeros_like(dxy)
        wt = self.weight()
        wv = mtx.dot(wt)
        out = np.full_like(dxy, np.nan)
        ok = wv > 0
        out[ok, 0] = mtx.dot(dxy[:, 0] * wt)[ok] / wv[ok]
        out[ok, 1] = mtx.dot(dxy[:, 1] * wt)[ok] / wv[ok]
        return out

    def spatial_autocorrelation(self, gear=const.MESH_GEAR_MOVING,
                                sigma=None):
        """1 -> residues vary smoothly in space (a coherent offset field,
        physical deformation); ~0 -> spatially uncorrelated (noise)
        (reference spatial_autocorrelation: optimizer.py:352-365)."""
        if self.smooth_matrix(sigma=sigma) is None:
            return 0.0
        dxy = self.dxy(gear=gear)
        dxy_sm = self.dxy_smoothen(gear=gear, sigma=sigma)
        wt = self.weight()
        rr = np.sum((dxy - dxy_sm) ** 2, axis=-1) \
            / np.maximum(np.sum(dxy ** 2, axis=-1)
                         + np.sum(dxy_sm ** 2, axis=-1), 1e-12)
        ok = np.isfinite(rr) & (wt > 0)
        if not ok.any():
            return 0.0
        return float(1.0 - np.average(rr[ok], weights=wt[ok]))

    def adjust_weight_from_residue(self, gear=const.MESH_GEAR_MOVING,
                                   residue_len=0, residue_mode=None):
        """Robust reweighting: 'huber' damps by residue_len/|r|; 'threshold'
        zeroes matches beyond residue_len (reference: optimizer.py:198-233);
        'huber_smooth' measures each match against the locally-smoothed
        residue field instead of zero, so a spatially COHERENT offset
        cluster (real deformation the solve has not absorbed yet) keeps
        its weight while incoherent outliers are damped (reference
        dxy_smoothen role: optimizer.py:334-350).
        Returns (changed, fraction_kept)."""
        if residue_mode is None or residue_len <= 0 or self.num_matches == 0:
            return False, 1.0
        r = self.residues(gear=gear)
        if residue_mode == 'huber':
            new_w = np.clip(residue_len / np.clip(r, 1e-9, None), None, 1.0)
        elif residue_mode == 'threshold':
            new_w = (r <= residue_len).astype(np.float64)
        elif residue_mode == 'huber_smooth':
            dev = self.dxy(gear=gear) - np.nan_to_num(
                self.dxy_smoothen(gear=gear))
            r_dev = np.linalg.norm(dev, axis=-1)
            new_w = np.clip(residue_len / np.clip(r_dev, 1e-9, None),
                            None, 1.0)
        else:
            raise ValueError(f'unknown residue mode {residue_mode}')
        changed = not np.allclose(new_w, self.residue_weight)
        self.residue_weight = new_w
        kept = float((self.weight() > 0).mean()) if new_w.size else 1.0
        return changed, kept

    def reset_residue_weight(self):
        self.residue_weight = np.ones(self._tid0.shape[0])

    def global_arrays(self, offset0, offset1):
        """(idx0, bary0, idx1, bary1, weight) with global vertex indices."""
        m0, m1 = self.meshes
        idx0 = m0.triangles[self._tid0] + offset0
        idx1 = m1.triangles[self._tid1] + offset1
        return idx0, self._bary0, idx1, self._bary1, self.weight()


def distribute_link(mesh0_list, mesh1_list, xy0, xy1, weight=None,
                    gear=const.MESH_GEAR_INITIAL, exclusive=True, **kwargs):
    """Distribute one link's matches over split meshes (reference
    distribute_link: optimizer.py:1818): each match goes to the component
    pair that actually contains its endpoints, so matches never tie
    disconnected pieces to the wrong fragment. Returns a list of Links."""
    xy0 = np.asarray(xy0, np.float64).reshape(-1, 2)
    xy1 = np.asarray(xy1, np.float64).reshape(-1, 2)
    n = xy0.shape[0]
    weight = np.ones(n) if weight is None else np.asarray(weight).ravel()
    remaining = np.arange(n)
    out = []
    for m0 in mesh0_list:
        if remaining.size == 0:
            break
        tid0 = m0.tri_finder(xy0[remaining], gear=gear)
        in0 = tid0 >= 0
        if not in0.any():
            continue
        cand0 = remaining[in0]
        for m1 in mesh1_list:
            if cand0.size == 0:
                break
            tid1 = m1.tri_finder(xy1[cand0], gear=gear)
            take = cand0[tid1 >= 0]
            if take.size == 0:
                continue
            link = Link.from_coordinates(m0, m1, xy0[take], xy1[take],
                                         weight=weight[take],
                                         gear=(gear, gear), **kwargs)
            if link.num_matches > 0:
                out.append(link)
            if exclusive:
                cand0 = np.setdiff1d(cand0, take)
                remaining = np.setdiff1d(remaining, take)
    return out


class SLM:
    """A system of meshes coupled by links (reference: optimizer.py:487)."""

    def __init__(self, meshes=None, links=None, **kwargs):
        self.meshes = list(meshes) if meshes else []
        self.links = list(links) if links else []
        self._stiffness_lambda = kwargs.get('stiffness_lambda', 1.0)
        self._crosslink_lambda = kwargs.get('crosslink_lambda', 1.0)
        self._dtype = kwargs.get('dtype', None)

    # ------------------------- bookkeeping ------------------------- #

    def add_mesh(self, mesh):
        self.meshes.append(mesh)

    def mesh_by_uid(self, uid):
        for m in self.meshes:
            if m.uid == uid:
                return m
        raise KeyError(uid)

    def add_link(self, link, check_duplicates=False):
        self.links.append(link)

    def add_link_from_coordinates(self, uid0, uid1, xy0, xy1, weight=None,
                                  gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL),
                                  **kwargs):
        link = Link.from_coordinates(self.mesh_by_uid(uid0), self.mesh_by_uid(uid1),
                                     xy0, xy1, weight=weight, gear=gear, **kwargs)
        if link.num_matches > 0:
            self.links.append(link)
        return link

    @property
    def num_meshes(self):
        return len(self.meshes)

    @property
    def lock_flags(self):
        return np.asarray([m.locked for m in self.meshes], dtype=bool)

    def active_links(self):
        return [l for l in self.links if (not l.disabled) and l.num_matches > 0
                and np.any(l.weight() > 0)]

    def divide_disconnected_submeshes(self, prune_links=True):
        """Split every disconnected mesh into its components and
        redistribute its links onto them (reference
        divide_disconnected_submeshes + distribute_link:
        optimizer.py:738,1818). Component uids extend the parent's with a
        decimal suffix; components remember their parent so
        :meth:`sync_component_positions` can write results back.
        Returns the number of meshes that were split."""
        replaced = {}
        new_meshes = []
        for m in self.meshes:
            if m.num_connected <= 1:
                new_meshes.append(m)
                continue
            comps = m.divide_disconnected_mesh()
            for k, c in enumerate(comps):
                c.uid = float(m.uid) + (k + 1) * 1e-3
                c.locked = m.locked
                c.soft_factor = m.soft_factor
            replaced[m.uid] = comps
            new_meshes.extend(comps)
        if not replaced:
            return 0
        self.meshes = new_meshes
        new_links = []
        for l in self.links:
            u0, u1 = l.uids
            if u0 not in replaced and u1 not in replaced:
                new_links.append(l)
                continue
            l0 = replaced.get(u0) or [self.mesh_by_uid(u0)]
            l1 = replaced.get(u1) or [self.mesh_by_uid(u1)]
            new_links.extend(distribute_link(
                l0, l1, l.xy0(gear=const.MESH_GEAR_INITIAL),
                l.xy1(gear=const.MESH_GEAR_INITIAL), weight=l.weight()))
        self.links = [l for l in new_links
                      if (not prune_links) or l.num_matches > 0]
        return len(replaced)

    def sync_component_positions(self, gear=const.MESH_GEAR_MOVING):
        """Write split-component vertex positions back into their parent
        meshes (inverse of :meth:`divide_disconnected_submeshes`)."""
        parents = {}
        for m in self.meshes:
            parent = getattr(m, '_parent_mesh', None)
            idx = getattr(m, '_parent_vertex_indices', None)
            if parent is None or idx is None:
                continue
            if id(parent) not in parents:
                if not parent.vertices_initialized(gear):
                    parent.set_vertices(parent.vertices(const.MESH_GEAR_FIXED),
                                        gear,
                                        offset=parent.offset(const.MESH_GEAR_FIXED))
                parents[id(parent)] = (parent,
                                       parent.vertices_w_offset(gear).copy())
            parents[id(parent)][1][idx] = m.vertices_w_offset(gear)
        for parent, mv in parents.values():
            center = mv.mean(axis=0, keepdims=True)
            parent.set_vertices(mv - center, gear, offset=center)
        return len(parents)

    def prune_links(self, min_matches=1):
        self.links = [l for l in self.links if l.num_matches >= min_matches]

    def clear_equation_terms(self):
        self._system = None

    def match_residues(self, gear=const.MESH_GEAR_MOVING, quantile=None):
        rr = [l.residues(gear=gear) for l in self.active_links()]
        if not rr:
            return np.zeros(0)
        r = np.concatenate(rr)
        if quantile is not None:
            return np.quantile(r, quantile)
        return r

    def mesh_connectivity(self):
        """Connected components of the mesh-link graph. Returns labels per
        mesh (locked meshes participate)."""
        import scipy.sparse as sparse
        import scipy.sparse.csgraph as csgraph
        n = self.num_meshes
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        rows, cols = [], []
        for l in self.active_links():
            u0, u1 = l.uids
            rows.append(uid2idx[u0])
            cols.append(uid2idx[u1])
        g = sparse.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
        _, labels = csgraph.connected_components(g, directed=False)
        return labels

    def flag_outcasts(self):
        """Flag meshes with no link path to an anchor (reference
        flag_outcasts: optimizer.py:1604): when any mesh is locked,
        components containing no locked mesh are outcasts; when the whole
        system free-floats, every component but the largest is. Sets
        ``mesh.is_outcast`` and returns the boolean array — callers use it
        to refuse committing/locking unanchored sections rather than
        persisting a placement the matches never determined."""
        labels = self.mesh_connectivity()
        lock_flags = np.asarray([m.locked for m in self.meshes], dtype=bool)
        prior = np.asarray([m.is_outcast for m in self.meshes], dtype=bool)
        if lock_flags.any():
            # fresh verdict from THIS system's connectivity: a section
            # flagged in an earlier (less connected) window must clear
            # once a path to an anchor exists. Prior-outcast locked
            # meshes don't anchor (their placement was never determined).
            anchored_labels = labels[lock_flags & ~prior]
            outcasts = ~np.isin(labels, anchored_labels)
        elif labels.max() == 0:
            # one fully-free component IS the majority component
            outcasts = np.zeros(self.num_meshes, dtype=bool)
        else:
            u, cnt = np.unique(labels, return_counts=True)
            outcasts = labels != u[np.argmax(cnt)]
        for m, flg in zip(self.meshes, outcasts):
            m.is_outcast = bool(flg)
        return outcasts

    # ------------------------- translation solve ------------------------- #

    def optimize_translation(self, **kwargs):
        """Per-mesh rigid translations minimizing weighted link residuals
        (reference optimize_translation_lsqr: optimizer.py:974). Locked
        meshes are fixed; per connected component with no locked mesh the
        weighted-mean translation is pinned to zero. Writes target_gear."""
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', target_gear)
        n = self.num_meshes
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        lock = self.lock_flags
        # sparse normal system: the link graph Laplacian. Dense (n,n)
        # storage is O(n^2) — 800 MB at the MultiSEM 10k-tile scale —
        # while the Laplacian has ~#overlaps nonzeros (ref lsqr path:
        # optimizer.py:974-1047)
        ii, jj, vv = [], [], []
        Atb = np.zeros((n, 2))
        for l in self.active_links():
            i0 = uid2idx[l.uids[0]]
            i1 = uid2idx[l.uids[1]]
            w2 = (l.weight() ** 2)
            sw = w2.sum()
            if sw <= 0:
                continue
            # residual r = (P1 + t1) - (P0 + t0); minimize sum w^2 |r|^2
            d = (l.dxy(gear=start_gear) * w2[:, None]).sum(axis=0)
            ii.extend((i0, i1, i0, i1))
            jj.extend((i0, i1, i1, i0))
            vv.extend((sw, sw, -sw, -sw))
            Atb[i0] += d
            Atb[i1] -= d
        AtA = sparse.coo_matrix(
            (np.asarray(vv, np.float64), (ii, jj)), shape=(n, n)).tocsr()
        labels = self.mesh_connectivity()
        t = np.zeros((n, 2))
        for lbl in np.unique(labels):
            sel = labels == lbl
            fixed = sel & lock
            free = sel & (~lock)
            if not free.any():
                continue
            fidx = np.flatnonzero(free)
            A = AtA[fidx][:, fidx].tocsr()
            b = Atb[fidx]
            diag = A.diagonal()
            if not fixed.any():
                # pure-translation null space: ridge + recenter below
                ridge = max(diag.max(initial=0.0), 1.0) * 1e-8
                A = A + sparse.identity(A.shape[0], format='csr') * ridge
                diag = diag + ridge
            sol = _sparse_spd_solve(A, b, diag)
            if sol is None:
                continue
            if not fixed.any():
                sol = sol - sol.mean(axis=0, keepdims=True)
            t[free] = sol
        for m, ti, lk in zip(self.meshes, t, lock):
            if lk:
                if not m.vertices_initialized(target_gear):
                    m.set_vertices(m.vertices(start_gear), target_gear,
                                   offset=m.offset(start_gear))
                continue
            m.set_vertices(m.vertices(start_gear), target_gear,
                           offset=m.offset(start_gear) + ti)
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    def optimize_translation_w_filtering(self, **kwargs):
        """Translation solve with iterative worst-link disabling
        (reference: optimizer.py:1081)."""
        residue_threshold = kwargs.pop('residue_threshold', None)
        maxpass = kwargs.pop('maxpass', 10)
        self.optimize_translation(**kwargs)
        if residue_threshold is None:
            return
        gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        for _ in range(maxpass):
            worst, worst_val = None, residue_threshold
            for l in self.active_links():
                r = np.median(l.residues(gear=gear))
                if r > worst_val:
                    worst, worst_val = l, r
            if worst is None:
                break
            worst.disable()
            self.optimize_translation(**kwargs)

    # ------------------------- affine cascade ------------------------- #

    def optimize_affine_cascade(self, **kwargs):
        """Greedy per-mesh (or per-group) affine placement: settled meshes
        (locked first, else the best-connected) anchor their neighbors,
        which are fitted by weighted affine on the link points and marked
        settled (reference: optimizer.py:1128). With ``groupings`` (array of
        group ids per mesh), all meshes of a group share one affine — used
        to bundle mFoV fixed-pattern distortion (reference:
        stitcher.py:844)."""
        groupings = kwargs.pop('groupings', None)
        if groupings is not None:
            return self._optimize_affine_grouped(np.asarray(groupings), **kwargs)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', const.MESH_GEAR_FIXED)
        svd_clip = kwargs.get('svd_clip', (0.5, 2.0))
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        n = self.num_meshes
        settled = self.lock_flags.copy()
        for m, lk in zip(self.meshes, settled):
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(start_gear), target_gear,
                               offset=m.offset(start_gear))
        links = self.active_links()
        if not settled.any() and n > 0:
            # seed: mesh with the most matches
            counts = np.zeros(n)
            for l in links:
                counts[uid2idx[l.uids[0]]] += l.num_matches
                counts[uid2idx[l.uids[1]]] += l.num_matches
            settled[int(np.argmax(counts))] = True
        while not settled.all():
            # pick the unsettled mesh with the most matches to settled ones
            score = np.zeros(n)
            pair_pts = {i: ([], [], []) for i in range(n)}
            for l in links:
                i0, i1 = uid2idx[l.uids[0]], uid2idx[l.uids[1]]
                if settled[i0] == settled[i1]:
                    continue
                if settled[i0]:
                    src, dst = i1, i0
                    p_src = l.xy1(gear=start_gear)
                    p_dst = l.xy0(gear=target_gear)
                else:
                    src, dst = i0, i1
                    p_src = l.xy0(gear=start_gear)
                    p_dst = l.xy1(gear=target_gear)
                w = l.weight()
                score[src] += w.sum()
                pair_pts[src][0].append(p_dst)
                pair_pts[src][1].append(p_src)
                pair_pts[src][2].append(w)
            score[settled] = -1
            nxt = int(np.argmax(score))
            if score[nxt] <= 0:
                # disconnected remainder: keep start positions
                for i in np.nonzero(~settled)[0]:
                    settled[i] = True
                break
            from feabas_tpu import spatial as sp
            p0 = np.concatenate(pair_pts[nxt][0])
            p1 = np.concatenate(pair_pts[nxt][1])
            w = np.concatenate(pair_pts[nxt][2])
            T, T_rigid = sp.fit_affine(p0, p1, weights=w, return_rigid=True)
            s = np.linalg.svd(T[:2, :2], compute_uv=False)
            if svd_clip is not None and (s.min() < svd_clip[0] or s.max() > svd_clip[1]):
                T = T_rigid
            m = self.meshes[nxt]
            m.apply_affine(T, gear=(start_gear, target_gear))
            settled[nxt] = True
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    def _optimize_affine_grouped(self, groupings, **kwargs):
        """Greedy affine cascade over mesh groups: links crossing group
        boundaries drive one weighted affine per group."""
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', const.MESH_GEAR_FIXED)
        svd_clip = kwargs.get('svd_clip', (0.5, 2.0))
        from feabas_tpu import spatial as sp
        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        for m in self.meshes:
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(start_gear), target_gear,
                               offset=m.offset(start_gear))
        groups = np.unique(groupings)
        gsettled = {g: bool(np.any(self.lock_flags[groupings == g]))
                    for g in groups}
        links = self.active_links()
        if not any(gsettled.values()):
            counts = {g: 0 for g in groups}
            for l in links:
                counts[groupings[uid2idx[l.uids[0]]]] += l.num_matches
                counts[groupings[uid2idx[l.uids[1]]]] += l.num_matches
            gsettled[max(counts, key=counts.get)] = True
        while not all(gsettled.values()):
            score = {g: 0.0 for g in groups if not gsettled[g]}
            pts = {g: ([], [], []) for g in groups if not gsettled[g]}
            for l in links:
                g0 = groupings[uid2idx[l.uids[0]]]
                g1 = groupings[uid2idx[l.uids[1]]]
                if gsettled.get(g0) == gsettled.get(g1):
                    continue
                if gsettled[g0]:
                    src, p_dst, p_src = g1, l.xy0(gear=target_gear), l.xy1(gear=start_gear)
                else:
                    src, p_dst, p_src = g0, l.xy1(gear=target_gear), l.xy0(gear=start_gear)
                w = l.weight()
                score[src] += w.sum()
                pts[src][0].append(p_dst)
                pts[src][1].append(p_src)
                pts[src][2].append(w)
            if not score or max(score.values()) <= 0:
                for g in score:
                    gsettled[g] = True
                break
            nxt = max(score, key=score.get)
            T, T_rigid = sp.fit_affine(np.concatenate(pts[nxt][0]),
                                       np.concatenate(pts[nxt][1]),
                                       weights=np.concatenate(pts[nxt][2]),
                                       return_rigid=True)
            s = np.linalg.svd(T[:2, :2], compute_uv=False)
            if svd_clip is not None and (s.min() < svd_clip[0] or s.max() > svd_clip[1]):
                T = T_rigid
            for i in np.nonzero(groupings == nxt)[0]:
                if not self.meshes[i].locked:
                    self.meshes[i].apply_affine(T, gear=(start_gear, target_gear))
            gsettled[nxt] = True
        r = self.match_residues(gear=target_gear)
        return float(r.max()) if r.size else 0.0

    # ------------------------- elastic solve (device) ------------------------- #

    def _build_system(self, shape_gear=const.MESH_GEAR_FIXED):
        """Concatenate meshes into global device arrays."""
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        nv = int(offsets[-1])
        uid2off = {m.uid: offsets[i] for i, m in enumerate(self.meshes)}
        free = np.ones((nv, 1), np.float32)
        for i, m in enumerate(self.meshes):
            if m.locked:
                free[offsets[i]:offsets[i + 1]] = 0.0
        groups = []
        dt = _solver_dtype()
        for i, m in enumerate(self.meshes):
            # per-mesh device element groups depend only on the shape-gear
            # geometry: memoize on the mesh (invalidated by set_vertices)
            # so the matcher's per-round rebuilds skip the shape-matrix
            # recompute and host->device conversions
            def _build(m=m):
                out = []
                for g in m.element_arrays(gear=shape_gear):
                    out.append({
                        'model': g['model'],
                        'tris_local': jnp.asarray(
                            m.triangles[g['start']:g['stop']]),
                        'B_area': fem.shape_matrices(
                            jnp.asarray(g['tripts'], dt)),
                        'multiplier': jnp.asarray(g['multiplier'], dt),
                        'poisson': jnp.asarray(g['poisson'], dt),
                        'knots': (None if g['knots'] is None else
                                  (jnp.asarray(g['knots'][0], dt),
                                   jnp.asarray(g['knots'][1], dt))),
                    })
                return out

            cached = m._memo(shape_gear, f'device_element_groups_{dt}',
                             _build)
            for g in cached:
                groups.append({**g, 'tris': g['tris_local'] + int(offsets[i])})
        la = [l.global_arrays(uid2off[l.uids[0]], uid2off[l.uids[1]])
              for l in self.active_links()]
        if la:
            idx0 = np.concatenate([a[0] for a in la])
            bary0 = np.concatenate([a[1] for a in la])
            idx1 = np.concatenate([a[2] for a in la])
            bary1 = np.concatenate([a[3] for a in la])
            weight = np.concatenate([a[4] for a in la])
            # pad the link count to a bucket (zero-weight rows are inert) so
            # the jitted CG program is reused across overlaps/rounds;
            # {8,12,16,24,...} buckets cap padding waste at 50%
            n = weight.shape[0]
            p2 = max(8, 1 << int(n - 1).bit_length())
            nb = p2 if n > 3 * p2 // 4 else 3 * p2 // 4
            if nb > n:
                pad = nb - n
                idx0 = np.concatenate([idx0, np.zeros((pad, 3), idx0.dtype)])
                bary0 = np.concatenate([bary0, np.zeros((pad, 3), bary0.dtype)])
                idx1 = np.concatenate([idx1, np.zeros((pad, 3), idx1.dtype)])
                bary1 = np.concatenate([bary1, np.zeros((pad, 3), bary1.dtype)])
                weight = np.concatenate([weight, np.zeros(pad, weight.dtype)])
            idx0 = jnp.asarray(idx0)
            bary0 = jnp.asarray(bary0)
            idx1 = jnp.asarray(idx1)
            bary1 = jnp.asarray(bary1)
            weight = jnp.asarray(weight)
        else:
            idx0 = jnp.zeros((0, 3), jnp.int32)
            bary0 = jnp.zeros((0, 3))
            idx1 = jnp.zeros((0, 3), jnp.int32)
            bary1 = jnp.zeros((0, 3))
            weight = jnp.zeros((0,))
        return {
            'nv': nv, 'offsets': offsets, 'free': jnp.asarray(free),
            'groups': groups,
            'links': (idx0, bary0, idx1, bary1, weight),
        }

    def _rigid_deflation_modes(self, pos_shape):
        """Orthonormal rigid modes (2 translations + 1 infinitesimal
        rotation about the component centroid, in shape-gear geometry) of
        every fully-free link-connected component, stacked (K, NV, 2) in
        global vertex numbering; None when every component is anchored by
        a locked mesh. Deflating these from the linear solve is the
        reference's extra-DOF removal for unlocked components
        (reference optimizer.py:1362-1377): without it the rotation
        direction has near-zero curvature but nonzero gradient and the
        solve buys residue reduction with a spurious whole-component
        rotation."""
        n = self.num_meshes
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        uid2idx = {m.uid: i for i, m in enumerate(self.meshes)}
        for l in self.active_links():
            a, b = find(uid2idx[l.uids[0]]), find(uid2idx[l.uids[1]])
            if a != b:
                parent[a] = b
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        comp_locked = {}
        for i, m in enumerate(self.meshes):
            r = find(i)
            comp_locked[r] = comp_locked.get(r, False) or m.locked
        nv = int(offsets[-1])
        comps = []
        for r, locked in comp_locked.items():
            if locked:
                continue
            rows = np.concatenate([np.arange(offsets[i], offsets[i + 1])
                                   for i in range(n) if find(i) == r])
            comps.append((rows, pos_shape[rows]))
        return rigid_modes_flat(nv, comps)

    def _gather_positions(self, gear):
        return np.concatenate([m.vertices_w_offset(gear) for m in self.meshes], axis=0)

    def _scatter_positions(self, pos, target_gear):
        offs = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        for i, m in enumerate(self.meshes):
            if m.locked:
                continue
            chunk = pos[offs[i]:offs[i + 1]]
            center = chunk.mean(axis=0, keepdims=True)
            m.set_vertices(chunk - center, target_gear, offset=center)

    @staticmethod
    def _element_terms(groups, u):
        """Tangent blocks + internal force per element group at displacement
        u (NV,2). Returns list of (tris, Ke, Pe)."""
        out = []
        for g in groups:
            B, area2 = g['B_area']
            uv = fem.gather_uv(u, g['tris'])
            mult = g['multiplier']
            if g['knots'] is not None:
                J = fem.area_stretch(B, uv)
                mult = mult * fem.stiffness_curve_multiplier(J, *g['knots'])
            if g['model'] == const.MATERIAL_MODEL_ENG:
                Ke = fem.eng_element_stiffness(B, area2, mult, g['poisson'])
                Pe = fem.eng_element_stress(Ke, uv)
            elif g['model'] == const.MATERIAL_MODEL_SVK:
                Ke, Pe = fem.svk_element(B, area2, uv, mult, g['poisson'])
            elif g['model'] == const.MATERIAL_MODEL_NHK:
                Ke, Pe = fem.nhk_element(B, area2, uv, mult)
            else:
                raise ValueError(f"unknown material model {g['model']}")
            out.append((g['tris'], Ke, Pe))
        return out

    def _balance_lambdas(self, sys_d, terms, lam_s, lam_c):
        """Negative lambdas -> trace-ratio auto balance (reference
        optimizer.py:1571): lam_s = |lam_s/lam_c| * tr(C) / tr(K restricted
        to crosslinked dofs); lam_c = 1."""
        if lam_s >= 0 and lam_c >= 0:
            return float(lam_s), float(lam_c)
        ratio = abs(lam_s / lam_c)
        nv = sys_d['nv']
        idx0, bary0, idx1, bary1, weight = sys_d['links']
        dC = fem.crosslink_diag(nv, idx0, bary0, idx1, bary1, weight,
                                dtype=_solver_dtype())
        dK = jnp.zeros((nv, 2), _solver_dtype())
        for tris, Ke, _ in terms:
            dK = dK + fem.stiffness_diag(Ke, tris, nv)
        tr_c = float(jnp.sum(dC))
        mask = np.asarray(dC) != 0
        tr_k = float(np.asarray(dK)[mask].sum())
        if tr_c == 0 or tr_k == 0:
            return 1.0, 1.0
        return abs(ratio * tr_c / tr_k), 1.0

    def _grouping_dof_map(self, groupings):
        """Projection map for grouped-elastic DOF sharing (reference
        optimizer.py:1378-1415): meshes in one group (identical topology)
        share one deformation field. Returns (dof_map (NV,), ndof,
        group_locked (num_meshes,)); a group is locked if ANY member is."""
        groupings = np.asarray(groupings).ravel()
        offsets = np.cumsum([0] + [m.num_vertices for m in self.meshes])
        dof_map = np.zeros(int(offsets[-1]), np.int64)
        reps = {}
        next_dof = 0
        glocked = {}
        for m, g in zip(self.meshes, groupings):
            glocked[g] = glocked.get(g, False) or m.locked
        for i, (m, g) in enumerate(zip(self.meshes, groupings)):
            if g not in reps:
                reps[g] = next_dof
                next_dof += m.num_vertices
            elif next_dof - reps[g] < m.num_vertices:
                raise ValueError('grouped meshes must share topology')
            dof_map[offsets[i]:offsets[i + 1]] = \
                reps[g] + np.arange(m.num_vertices)
        group_locked = np.asarray([glocked[g] for g in groupings], bool)
        return dof_map, next_dof, group_locked

    def optimize_linear(self, **kwargs):
        """One (tangent) elastic solve.

        Energy: lam_s/2 u'Ku + lam_c/2 |W C p|^2 over free meshes, u the
        displacement from shape_gear geometry, p the world positions.
        Solves A dx = b matrix-free and writes start + dx into target_gear.
        Commits ONLY when the solve converged (post-residual below ||b||,
        reference divergence refusal: optimizer.py:1420-1421); otherwise
        positions are left untouched and ``last_solve_converged`` is False.
        With ``groupings``, meshes of one group share one deformation via
        DOF projection (reference: optimizer.py:1378-1415).
        Returns (cost_before, cost_after) as weighted residue norms.
        """
        tol = kwargs.get('tol', 1e-7)
        atol = kwargs.get('atol', 0.0)
        maxiter = kwargs.get('maxiter', None)
        maxiter = 10000 if maxiter is None else int(maxiter)
        chances = kwargs.get('chances', None)
        shape_gear = kwargs.get('shape_gear', const.MESH_GEAR_FIXED)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        start_gear = kwargs.get('start_gear', target_gear)
        lam_s = kwargs.get('stiffness_lambda', self._stiffness_lambda)
        lam_c = kwargs.get('crosslink_lambda', self._crosslink_lambda)
        groupings = kwargs.get('groupings', None)
        check_converge = kwargs.get('check_converge', True)
        if np.all(self.lock_flags) or self.num_meshes == 0:
            return 0.0, 0.0
        self.last_solve_converged = True
        sys_d = self._build_system(shape_gear=shape_gear)
        pos_start = self._gather_positions(start_gear)
        pos_shape = self._gather_positions(shape_gear)
        # fast path: all groups linear ENG (no stiffness curve) +
        # auto-balanced lambdas -> one fused jitted dispatch (dominant
        # case: matching, window alignment, locked+moving tile pairs)
        groups = sys_d['groups']
        all_eng = all(g['model'] == const.MATERIAL_MODEL_ENG
                      and g['knots'] is None for g in groups)
        self._last_solve_fused = False
        self._last_solve_sharded = False
        if (all_eng and groups and lam_s < 0 and lam_c < 0
                and groupings is None
                and sys_d['links'][4].shape[0] > 0):
            # montage-scale systems with >1 device: shard the tile axis
            # over the device mesh (per-tile FEM local, link coupling via
            # XLA collectives) instead of solving on one chip
            n_dev = jax.local_device_count()
            min_tiles = int(os.environ.get('FEABAS_TPU_SHARD_MIN_TILES',
                                           max(2 * n_dev, 16)))
            if n_dev > 1 and len(self.meshes) >= min_tiles:
                from feabas_tpu.parallel.montage import (
                    sharded_montage_linear_solve)
                out = sharded_montage_linear_solve(
                    self, abs(lam_s / lam_c), shape_gear=shape_gear,
                    start_gear=start_gear, target_gear=target_gear,
                    tol=tol, atol=atol, maxiter=int(maxiter),
                    commit_non_converged=not check_converge)
                if out is not None:
                    cost0, cost1, ok = out
                    self._last_solve_fused = True
                    self._last_solve_sharded = True
                    if not ok:
                        self.last_solve_converged = False
                        if check_converge:
                            return cost0, cost0
                    return cost0, cost1
            self._last_solve_fused = True
            idx0, bary0, idx1, bary1, weight = sys_d['links']
            dt = _solver_dtype()
            deflate = self._rigid_deflation_modes(pos_shape)
            tris = jnp.concatenate([g['tris'] for g in groups])
            B = jnp.concatenate([g['B_area'][0] for g in groups])
            area2 = jnp.concatenate([g['B_area'][1] for g in groups])
            mult = jnp.concatenate([g['multiplier'] for g in groups])
            poisson = jnp.concatenate([g['poisson'] for g in groups])
            p_start = jnp.asarray(pos_start, dt)
            offs = sys_d['offsets']
            agg = np.repeat(np.arange(len(self.meshes)), np.diff(offs))
            mesh_free = np.asarray(
                [0.0 if m.locked else 1.0 for m in self.meshes], np.float64)
            packed = np.asarray(_linear_solve_eng(
                tris, B, area2, mult, poisson,
                idx0, bary0, idx1, bary1, weight,
                p_start, jnp.asarray(pos_shape, dt),
                sys_d['free'].astype(dt),
                abs(lam_s / lam_c), tol, atol, int(maxiter),
                offsets_arr=jnp.asarray(offs),
                agg=jnp.asarray(agg, jnp.int32),
                mesh_free=jnp.asarray(mesh_free, dt),
                modes=None if deflate is None else jnp.asarray(deflate, dt)))
            dx = packed[:-2]
            bnorm, res = float(packed[-2, 0]), float(packed[-2, 1])
            cost0 = float(packed[-1, 0])
            _solver_log().debug(
                'fused ENG solve: %d CG iters, |b|=%.3e, res=%.3e',
                int(packed[-1, 1]), bnorm, res)
            ok = res < bnorm or res <= max(tol * bnorm, atol)
            if check_converge and not ok:
                self.last_solve_converged = False
                return cost0, cost0
            self._scatter_positions(pos_start + dx, target_gear)
            r1 = self.match_residues(gear=target_gear)
            w_all = np.concatenate([l.weight() for l in self.active_links()]) \
                if self.active_links() else np.zeros(0)
            cost1 = float(np.linalg.norm(r1 * w_all)) if r1.size else 0.0
            return cost0, cost1
        u_cur = jnp.asarray(pos_start - pos_shape)
        terms = self._element_terms(sys_d['groups'], u_cur)
        lam_s, lam_c = self._balance_lambdas(sys_d, terms, lam_s, lam_c)
        idx0, bary0, idx1, bary1, weight = sys_d['links']
        free = sys_d['free']
        if groupings is not None:
            dof_map, ndof, group_locked = self._grouping_dof_map(groupings)
            # group lock discipline: any locked member locks the group
            offs = np.cumsum([0] + [m.num_vertices for m in self.meshes])
            free = np.array(free)  # writable host copy
            for i, lk in enumerate(group_locked):
                if lk:
                    free[offs[i]:offs[i + 1]] = 0.0
            free = jnp.asarray(free)
            dof_map_j = jnp.asarray(dof_map)
        free = free.astype(u_cur.dtype)
        nv = sys_d['nv']
        deflate = None if groupings is not None else \
            self._rigid_deflation_modes(pos_shape)
        proj = _mode_projector(None if deflate is None
                               else jnp.asarray(deflate, u_cur.dtype))

        def matvec_full(x):
            x = proj(x * free)
            y = jnp.zeros_like(x)
            for tris, Ke, _ in terms:
                y = y + fem.stiffness_matvec(x, Ke, tris) * lam_s
            y = y + fem.crosslink_matvec(x, idx0, bary0, idx1, bary1,
                                         weight) * lam_c
            return proj(y * free)

        # rhs: -(lam_s * P(u) + lam_c * C^T W r)
        b = jnp.zeros_like(u_cur)
        for tris, _, Pe in terms:
            b = b - fem.scatter_uv(Pe, tris, nv) * lam_s
        pos0 = jnp.asarray(pos_start)
        r0 = fem.link_eval(pos0, idx1, bary1) - fem.link_eval(pos0, idx0, bary0)
        rw = r0 * (weight ** 2)[:, None]
        b = b.at[idx1].add(-bary1[:, :, None] * rw[:, None, :] * lam_c)
        b = b.at[idx0].add(bary0[:, :, None] * rw[:, None, :] * lam_c)
        b = b * free

        diag = jnp.zeros_like(u_cur)
        for tris, Ke, _ in terms:
            diag = diag + fem.stiffness_diag(Ke, tris, nv) * lam_s
        diag = diag + fem.crosslink_diag(nv, idx0, bary0, idx1, bary1, weight,
                                         dtype=u_cur.dtype) * lam_c

        cost0 = float(jnp.linalg.norm(r0 * weight[:, None]))
        if groupings is None:
            b = proj(b)
            diag = jnp.where(free > 0, diag, 1.0)
            offs = sys_d['offsets']
            agg = np.repeat(np.arange(len(self.meshes)), np.diff(offs))
            mesh_free = np.asarray(
                [0.0 if m.locked else 1.0 for m in self.meshes],
                np.float64)
            precond = _flat_translation_precond(
                jnp.asarray(offs), jnp.asarray(agg, jnp.int32),
                jnp.asarray(mesh_free, u_cur.dtype), idx0, idx1, weight,
                lam_c, diag, free, u_cur.dtype)
            if precond is not None and deflate is not None:
                inner = precond
                precond = lambda r: proj(inner(proj(r)))
            dx, n_it, res = fem.cg_solve(matvec_full, b, diag=diag, tol=tol,
                                         atol=atol, maxiter=int(maxiter),
                                         chances=chances, precond=precond)
            bnorm = float(jnp.linalg.norm(b))
            dx = np.asarray(proj(dx) * free)
            _solver_log().debug('linear solve: %d CG iters, |b|=%.3e, res=%.3e',
                                int(n_it), bnorm, float(res))
        else:
            # projected system: P^T A P with P = expansion by dof_map
            def seg(y):
                return jnp.zeros((ndof, 2), y.dtype).at[dof_map_j].add(y)

            def matvec_s(xs):
                return seg(matvec_full(xs[dof_map_j]))

            b_s = seg(b)
            diag_s = seg(diag)
            diag_s = jnp.where(diag_s > 0, diag_s, 1.0)
            dxs, n_it, res = fem.cg_solve(matvec_s, b_s, diag=diag_s, tol=tol,
                                          atol=atol, maxiter=int(maxiter),
                                          chances=chances)
            bnorm = float(jnp.linalg.norm(b_s))
            dx = np.asarray(dxs[dof_map_j] * free)
        ok = (float(res) < bnorm or float(res) <= max(tol * bnorm, atol))
        if check_converge and not ok:
            self.last_solve_converged = False
            return cost0, cost0
        self._scatter_positions(pos_start + dx, target_gear)
        r1 = self.match_residues(gear=target_gear)
        w_all = np.concatenate([l.weight() for l in self.active_links()]) \
            if self.active_links() else np.zeros(0)
        cost1 = float(np.linalg.norm(r1 * w_all)) if r1.size else 0.0
        return cost0, cost1

    def _snapshot_positions(self, gear):
        return [(m.vertices(gear).copy(), m.offset(gear).copy())
                for m in self.meshes]

    def _restore_positions(self, snap, gear):
        for m, (v, off) in zip(self.meshes, snap):
            m.set_vertices(v, gear, offset=off)

    def _count_flips(self, gear):
        return sum(int(m.flipped_triangles(gear).size)
                   for m in self.meshes if not m.locked)

    def optimize_Newton_Raphson(self, **kwargs):
        """Newton iterations for nonlinear materials: re-linearize, solve,
        damp on divergence, stop on small updates (reference:
        optimizer.py:1440). Each outer step reuses optimize_linear with
        start=target gear.

        Flip guard: when a step introduces NEW flipped triangles, the step
        is rolled back and retried with the crosslink term shrunk by
        ``crosslink_shrink`` (up to ``shrink_trial`` times) so the meshes
        take a stiffer, smaller step (reference crosslink_shrink intent:
        optimizer.py:1457-1461, per-step relax: :1514-1546). A diverged
        linear solve (refused commit) ends the loop with the best-so-far
        state intact."""
        max_newtonstep = kwargs.pop('max_newtonstep', 5)
        crosslink_shrink = float(kwargs.pop('crosslink_shrink', 0.5))
        shrink_trial = int(kwargs.pop('shrink_trial', 3))
        deform_outlier_constant = kwargs.pop('deform_outlier_constant', 0)
        target_gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
        kwargs.setdefault('start_gear', target_gear)
        residue_mode = kwargs.pop('residue_mode', None)
        residue_len = kwargs.pop('residue_len', 0)
        # per-step annealing rebases the resting state onto the current
        # solution so nonlinear materials re-linearize around it
        # (reference per-Newton-step anneal: optimizer.py:1514)
        anneal_mode = kwargs.pop('anneal_mode', None)
        # ensure target gear initialized
        for m in self.meshes:
            if not m.vertices_initialized(target_gear):
                m.set_vertices(m.vertices(kwargs['start_gear']), target_gear,
                               offset=m.offset(kwargs['start_gear']))
        cost0 = cost1 = None
        lam_c_base = kwargs.get('crosslink_lambda', self._crosslink_lambda)
        for step in range(max(int(max_newtonstep), 1)):
            pre_flips = self._count_flips(target_gear)
            snap = self._snapshot_positions(target_gear)
            lam_c = lam_c_base
            for trial in range(max(shrink_trial, 1)):
                c0, c1 = self.optimize_linear(
                    **{**kwargs, 'start_gear': target_gear,
                       'crosslink_lambda': lam_c})
                if self._count_flips(target_gear) <= pre_flips:
                    break
                # new flips: roll back and take a stiffer, smaller step
                self._restore_positions(snap, target_gear)
                lam_c = lam_c * crosslink_shrink
            if cost0 is None:
                cost0 = c0
            if not getattr(self, 'last_solve_converged', True):
                break
            cost1 = c1
            if residue_mode is not None and residue_len > 0:
                for l in self.active_links():
                    l.adjust_weight_from_residue(gear=target_gear,
                                                 residue_len=residue_len,
                                                 residue_mode=residue_mode)
            if anneal_mode is not None:
                if deform_outlier_constant and deform_outlier_constant > 0:
                    # relax IQR-outlier deformation hotspots before the
                    # anneal locks them in (reference: optimizer.py:1514)
                    for m in self.meshes:
                        if not m.locked:
                            relax_mesh_most_deformed(
                                m, iqr_factor=float(deform_outlier_constant))
                for m in self.meshes:
                    if not m.locked:
                        m.anneal(gear=(target_gear, const.MESH_GEAR_FIXED),
                                 mode=anneal_mode)
            if c0 <= 0 or abs(c0 - c1) <= 1e-4 * max(c0, 1e-12):
                break
        return cost0 or 0.0, cost1 or 0.0

    @property
    def is_linear(self):
        for m in self.meshes:
            uid2mat = m.material_table.uid_to_material()
            for uid in np.unique(m.material_ids):
                mat = uid2mat.get(int(uid))
                if mat is not None and not mat.is_linear:
                    return False
        return True

    def optimize_elastic(self, **kwargs):
        """Dispatcher: single linear solve for all-linear systems, Newton
        otherwise (reference: optimizer.py:1547)."""
        if self.is_linear:
            residue_mode = kwargs.pop('residue_mode', None)
            residue_len = kwargs.pop('residue_len', 0)
            max_passes = kwargs.pop('max_residue_passes', 3)
            out = self.optimize_linear(**kwargs)
            if residue_mode is not None and residue_len > 0:
                gear = kwargs.get('target_gear', const.MESH_GEAR_MOVING)
                for _ in range(max_passes):
                    changed = False
                    for l in self.active_links():
                        ch, _ = l.adjust_weight_from_residue(
                            gear=gear, residue_len=residue_len,
                            residue_mode=residue_mode)
                        changed |= ch
                    if not changed:
                        break
                    out = (out[0], self.optimize_linear(**kwargs)[1])
            return out
        return self.optimize_Newton_Raphson(**kwargs)


def relax_mesh(mesh, free_vertices=None, **kwargs):
    """Locally relax a mesh: hold all vertices except ``free_vertices`` and
    minimize elastic energy (reference relax_mesh: optimizer.py:2110).
    Operates on the MOVING gear in place."""
    target_gear = kwargs.pop('target_gear', const.MESH_GEAR_MOVING)
    if free_vertices is None:
        free_vertices = np.ones(mesh.num_vertices, bool)
    free = np.zeros((mesh.num_vertices, 1), np.float32)
    free[np.asarray(free_vertices)] = 1.0
    groups = mesh.element_arrays(gear=const.MESH_GEAR_INITIAL)
    pos = mesh.vertices_w_offset(target_gear)
    pos_init = mesh.vertices_w_offset(const.MESH_GEAR_INITIAL)
    u = jnp.asarray(pos - pos_init)
    freej = jnp.asarray(free, u.dtype)
    nv = mesh.num_vertices
    terms = []
    for g in groups:
        tris = jnp.asarray(mesh.triangles[g['start']:g['stop']])
        B, area2 = fem.shape_matrices(jnp.asarray(g['tripts'], u.dtype))
        Ke = fem.eng_element_stiffness(B, area2, jnp.asarray(g['multiplier'], u.dtype),
                                       jnp.asarray(g['poisson'], u.dtype))
        terms.append((tris, Ke))

    def matvec(x):
        x = x * freej
        y = jnp.zeros_like(x)
        for tris, Ke in terms:
            y = y + fem.stiffness_matvec(x, Ke, tris)
        return y * freej

    b = jnp.zeros_like(u)
    for tris, Ke in terms:
        b = b - fem.stiffness_matvec(u, Ke, tris)
    b = b * freej
    diag = jnp.zeros_like(u)
    for tris, Ke in terms:
        diag = diag + fem.stiffness_diag(Ke, tris, nv)
    diag = jnp.where(freej > 0, diag, 1.0)
    dx, _, _ = fem.cg_solve(matvec, b, diag=diag,
                            tol=kwargs.get('tol', 1e-7), maxiter=2000)
    newpos = pos + np.asarray(dx * freej)
    center = newpos.mean(axis=0, keepdims=True)
    mesh.set_vertices(newpos - center, target_gear, offset=center)
    return mesh


def relax_mesh_most_deformed(mesh, deform_quantile=0.75, iqr_factor=1.5, **kwargs):
    """Relax vertices of triangles whose deformation is an IQR outlier
    (reference: optimizer.py:2157)."""
    d = mesh.svds_to_deform(gear1=const.MESH_GEAR_MOVING)
    q1, q3 = np.quantile(d, [0.25, 0.75])
    thresh = q3 + iqr_factor * (q3 - q1)
    bad_tris = d > max(thresh, 1e-3)
    if not bad_tris.any():
        return mesh, False
    free = np.zeros(mesh.num_vertices, bool)
    free[np.unique(mesh.triangles[bad_tris])] = True
    relax_mesh(mesh, free_vertices=free, **kwargs)
    return mesh, True


def coarse_mesh_SLM(slm, mesh_reduction_factor=0.25, **kwargs):
    """Relax a coarse surrogate system and map the result onto the fine
    meshes (reference coarse_mesh_SLM + apply_coarse_relaxation_results:
    optimizer.py:1192-1256). Used as the cheap 'affine' stage: with
    reduction 0 each mesh moves by one affine.

    Operates from the meshes' current MOVING placement; writes MOVING.
    """
    from feabas_tpu.mesh import transform_mesh
    coarse = []
    for m in slm.meshes:
        cm = m.coarse_mesh(mesh_reduction_factor, gear=const.MESH_GEAR_MOVING)
        cm.locked = m.locked
        coarse.append(cm)
    cslm = SLM(coarse)
    for l in slm.active_links():
        cslm.add_link_from_coordinates(
            l.uids[0], l.uids[1],
            l.xy0(gear=const.MESH_GEAR_MOVING), l.xy1(gear=const.MESH_GEAR_MOVING),
            weight=l.weight(),
            gear=(const.MESH_GEAR_INITIAL, const.MESH_GEAR_INITIAL))
    cslm.optimize_elastic(
        stiffness_lambda=kwargs.get('stiffness_lambda', -0.35),
        crosslink_lambda=-1.0,
        tol=kwargs.get('tol', 1e-6),
        maxiter=kwargs.get('maxiter', None),
        residue_mode=kwargs.get('residue_mode', None),
        residue_len=kwargs.get('residue_len', 0))
    for m, cm in zip(slm.meshes, coarse):
        if m.locked:
            continue
        # resample the fine mesh's current MOVING positions through the
        # coarse deformation (coarse INITIAL frame == fine MOVING frame)
        probe = m.copy()
        probe.set_vertices(m.vertices(const.MESH_GEAR_MOVING),
                           const.MESH_GEAR_FIXED,
                           offset=m.offset(const.MESH_GEAR_MOVING))
        out = transform_mesh(probe, cm,
                             gear=(const.MESH_GEAR_FIXED, const.MESH_GEAR_MOVING))
        mv = out.vertices_w_offset(const.MESH_GEAR_MOVING)
        center = mv.mean(axis=0, keepdims=True)
        m.set_vertices(mv - center, const.MESH_GEAR_MOVING, offset=center)
    r = slm.match_residues(gear=const.MESH_GEAR_MOVING)
    return float(r.max()) if r.size else 0.0
