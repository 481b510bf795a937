"""Fused fine-round match loop: the matcher's whole coarse-to-fine block
schedule as ONE device program.

The classic path (matcher.iterative_xcorr_matcher_w_mesh) pays a
host<->device round trip per round for the xcorr peaks plus one per
elastic solve — the structural floor of that design. Here every
round (per-block affine from the CURRENT mesh positions -> batched warp
-> DoG -> FFT xcorr -> link targets -> Jacobi-PCG elastic solve -> Huber
reweight) chains on device, so a whole tile-pair fine stage costs one
dispatch and one fetch. Host work shrinks to block-lattice planning
(per-round centers/triangle assignments are frozen at the post-coarse-
seed geometry — stitching deformations are a few pixels against
~100-pixel triangles, so assignments cannot drift).

Applies to the dominant stitching case: mesh0 locked, mesh1 linear-ENG
free, cartesian block lattice, fixed spacing schedule. The adaptive
dwell/enlarge/skip schedule falls back to the classic loop (reference
behavior: feabas/matcher.py:430-777).
"""

import functools

import jax
import jax.numpy as jnp

from feabas_tpu.ops import fem
from feabas_tpu.ops.filters import masked_dog_filter
from feabas_tpu.ops.warp import affine_warp_blocks_shifted
from feabas_tpu.ops.xcorr import _peak_and_subpixel


def _mesh1_block_affines(pos, verts0, tri_idx):
    """Per-block affine mapping CURRENT (MOVING) world -> source (INITIAL)
    pixel coords, from the triangle containing each block center.

    tri_idx: (B, 3) vertex ids. Returns A (B,2,2), b (B,2) so that
    src = world @ A + b. The solve runs in centroid-centered coordinates:
    absolute tile coordinates (~4000 px) against ~100 px triangles make
    the raw 3x3 system ill-scaled in f32 (the classic host path does this
    math in f64)."""
    Vm = pos[tri_idx]       # (B,3,2) current
    Vi = verts0[tri_idx]    # (B,3,2) source
    # closed-form elementwise solve (no dot_general or LU): plain f32
    # arithmetic, independent of the matmul precision
    em1 = Vm[:, 1] - Vm[:, 0]
    em2 = Vm[:, 2] - Vm[:, 0]
    ei1 = Vi[:, 1] - Vi[:, 0]
    ei2 = Vi[:, 2] - Vi[:, 0]
    det = em1[:, 0] * em2[:, 1] - em1[:, 1] * em2[:, 0]
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    # A = inv([em1; em2]) @ [ei1; ei2]  (row-vector convention)
    A = jnp.stack([
        jnp.stack([(em2[:, 1] * ei1[:, 0] - em1[:, 1] * ei2[:, 0]) / det,
                   (em2[:, 1] * ei1[:, 1] - em1[:, 1] * ei2[:, 1]) / det],
                  axis=-1),
        jnp.stack([(-em2[:, 0] * ei1[:, 0] + em1[:, 0] * ei2[:, 0]) / det,
                   (-em2[:, 0] * ei1[:, 1] + em1[:, 0] * ei2[:, 1]) / det],
                  axis=-1),
    ], axis=1)                                       # (B,2,2)
    b = Vi[:, 0] - (Vm[:, 0, 0:1] * A[:, 0, :] + Vm[:, 0, 1:2] * A[:, 1, :])
    return A, b


def _centered_bary(P, pts):
    """Barycentric coords of pts (B,2) w.r.t. triangles P (B,3,2) by the
    closed-form signed-area ratios — elementwise f32 only (see
    _mesh1_block_affines on why no dot_general), translation-invariant."""
    q = pts - P[:, 0]
    e1 = P[:, 1] - P[:, 0]
    e2 = P[:, 2] - P[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    b1 = (q[:, 0] * e2[:, 1] - q[:, 1] * e2[:, 0]) / det
    b2 = (e1[:, 0] * q[:, 1] - e1[:, 1] * q[:, 0]) / det
    return jnp.stack([1.0 - b1 - b2, b1, b2], axis=-1)


def _solve_round(pos, u_shape, Ke, tris1, nv, idx_a, bary_a, w, targets,
                 lam_ratio, tol, maxiter, dK0, idx0_a, bary0_a):
    """One tangent elastic solve of mesh1 against fixed link targets.

    Energy: lam_s/2 u'Ku + 1/2 |w (B pos - targets)|^2 with trace-ratio
    lambda balance. The balance must match the classic two-mesh system
    (optimizer._linear_solve_eng), where the LOCKED mesh0's stiffness
    diagonal and anchor contributions also enter the traces — omitting
    them over-stiffens a soft mesh1 by (1+s)/(2s)."""
    dt = pos.dtype
    dK = fem.stiffness_diag(Ke, tris1, nv)
    w2b = (bary_a ** 2) * (w ** 2)[:, None]
    dC = jnp.zeros((nv, 2), dt).at[idx_a].add(
        w2b[:, :, None] * jnp.ones((1, 1, 2), dt))
    w2b0 = (bary0_a ** 2) * (w ** 2)[:, None]
    dC0 = jnp.zeros(dK0.shape, dt).at[idx0_a].add(
        w2b0[:, :, None] * jnp.ones((1, 1, 2), dt))
    tr_c = jnp.sum(dC) + jnp.sum(dC0)
    tr_k = (jnp.sum(jnp.where(dC != 0, dK, 0.0))
            + jnp.sum(jnp.where(dC0 != 0, dK0, 0.0)))
    okl = (tr_c > 0) & (tr_k > 0)
    lam_s = jnp.where(okl, lam_ratio * tr_c / jnp.where(tr_k > 0, tr_k, 1.0),
                      1.0)

    def matvec(x):
        y = fem.stiffness_matvec(x, Ke, tris1) * lam_s
        px = (x[idx_a] * bary_a[..., None]).sum(axis=1)
        r = px * (w ** 2)[:, None]
        y = y.at[idx_a].add(bary_a[:, :, None] * r[:, None, :])
        return y

    u = pos - u_shape
    b = -fem.stiffness_matvec(u, Ke, tris1) * lam_s
    p1 = (pos[idx_a] * bary_a[..., None]).sum(axis=1)
    r0 = (p1 - targets) * (w ** 2)[:, None]
    b = b.at[idx_a].add(-bary_a[:, :, None] * r0[:, None, :])
    diag = dK * lam_s + dC
    diag = jnp.where(diag > 0, diag, 1.0)
    # chances: f32 CG stalls at its precision floor well before tol 1e-8 —
    # stop after 25 non-improving iterations instead of burning maxiter
    dx, _n_it, _res = fem.cg_solve(matvec, b, diag=diag, tol=tol,
                                   maxiter=maxiter, chances=25)
    return pos + dx


def _avg_pool(img, k):
    H = (img.shape[0] // k) * k
    W = (img.shape[1] // k) * k
    return img[:H, :W].reshape(H // k, k, W // k, k).mean(axis=(1, 3))


def _fused_rounds_core(src0, src1, pos1, verts0_1, shape1, tris1, multiplier,
                       poisson, rounds, meta, shape0, tris0, multiplier0,
                       poisson0, pos0, lam_ratio=0.35, sigma=2.5,
                       conf_thresh=0.3, huber_passes=2, maxiter=600,
                       coarse=None, coarse_meta=None, fft_chunk=128,
                       env_norm=True):
    """Run the full fine-match schedule on device.

    Args:
        src0/src1: source images (any dtype; cast to f32 on device),
            pixel (0,0) at world offsets baked into the affines.
        pos1: (V,2) mesh1 current MOVING positions.
        verts0_1: (V,2) mesh1 source (INITIAL) vertices in src1 PIXEL
            coordinates (offset folded in).
        shape1: (V,2) mesh1 shape-gear (FIXED) positions for the elastic
            energy reference.
        tris1: (E,3), multiplier/poisson: (E,) element arrays.
        rounds: tuple of per-round dicts of device arrays:
            origins (B,2), A0 (B,2,2), b0 (B,2)  [mesh0 side, constant],
            tri_idx (B,3)  [mesh1 triangle vertex ids per block],
            centers (B,2)  [block centers, world frame],
            anchor_idx (B,3), anchor_idx0 (B,3)  [link anchor triangles;
            barycentrics are computed at measurement time on device],
            valid (B,)  [0 for padding rows],
            env_ok (B,)  [1 where the block's whole source read window is
            interior to both sources' valid extents — the blocks whose
            final-round peak divides by the analytic overlap envelope],
            rlen (scalar)  [Huber residue length].
        meta: tuple of per-round static (block_size, fft_y, fft_x,
            subpixel, translate_first, tol, warp_window_K).
    Returns:
        one packed (V + 3*B_last + 2, 2) array — [pos1_final; d_last;
        (conf_last, w_last) column-stacked; measurement-time anchor bary
        (first two components; the third is 1-b0-b1); coarse stats
        [[conf, 0], [delta_x, delta_y]] (zeros when no in-program
        coarse)] — so the caller pays a single device->host fetch.
    """
    f0 = src0.astype(jnp.float32)
    f1 = src1.astype(jnp.float32)
    nv = pos1.shape[0]
    dt = pos1.dtype
    # optional in-program coarse seed: pooled whole-band xcorr replaces
    # the host-side global_translation_matcher dispatch, so a whole tile
    # pair costs ONE device round trip. Inputs are stage-prior-aligned
    # crops; the measured residual shifts mesh1's positions before the
    # fine rounds (frozen lattice/anchors stay exact — the mesh is still
    # an undeformed translation at this point).
    coarse_stats = jnp.zeros((2, 2), dt)
    if coarse_meta is not None:
        pool, cfy, cfx, csigma = coarse_meta
        p0 = _avg_pool(f0, pool)
        p1 = _avg_pool(f1, pool)

        def _vmask(p, v):
            iy = jnp.arange(p.shape[0])[:, None]
            ix = jnp.arange(p.shape[1])[None, :]
            return ((iy < v[0]) & (ix < v[1])).astype(jnp.float32)

        m0 = _vmask(p0, coarse['v0'])
        m1 = _vmask(p1, coarse['v1'])
        g0 = masked_dog_filter(p0[None], csigma, mask=m0[None])
        g1 = masked_dog_filter(p1[None], csigma, mask=m1[None])
        F0 = jnp.fft.rfft2(g0, s=(cfy, cfx))
        F1 = jnp.fft.rfft2(g1, s=(cfy, cfx))
        C = jnp.fft.irfft2(jnp.conj(F0) * F1, s=(cfy, cfx))
        dxc, dyc, _pk = _peak_and_subpixel(C, (cfy, cfx), False)
        # recenter to array-center overlay (shapes may differ), wrap torus
        dyc = dyc + (p0.shape[0] - p1.shape[0]) / 2
        dxc = dxc + (p0.shape[1] - p1.shape[1]) / 2
        dyc = dyc - jnp.round(dyc / cfy) * cfy
        dxc = dxc - jnp.round(dxc / cfx) * cfx
        Cm = jnp.abs(jnp.fft.irfft2(F0 * F1, s=(cfy, cfx)))
        mx_rl = C.reshape(1, -1).max(axis=-1)
        mx_mr = Cm.reshape(1, -1).max(axis=-1)
        conf_c = jnp.clip(jnp.where(
            mx_rl > 0, 1.0 - mx_mr / jnp.where(mx_rl > 0, mx_rl, 1.0),
            0.0), 0.0, 1.0)[0]
        d_full = jnp.stack([dxc[0], dyc[0]]).astype(dt) * pool
        delta = coarse['base'].astype(dt) - d_full
        pos1 = pos1 + delta
        coarse_stats = jnp.stack([
            jnp.stack([conf_c.astype(dt), jnp.asarray(0.0, dt)]), delta])
    B_mat, area2 = fem.shape_matrices(shape1[tris1])
    Ke = fem.eng_element_stiffness(B_mat, area2, multiplier, poisson)
    # locked mesh0 enters only the lambda-balance traces
    B0_mat, area2_0 = fem.shape_matrices(shape0[tris0])
    Ke0 = fem.eng_element_stiffness(B0_mat, area2_0, multiplier0, poisson0)
    dK0 = fem.stiffness_diag(Ke0, tris0, shape0.shape[0])
    d_last = None
    conf_last = None
    w_last = None
    for r, (rd, (bs, fy, fx, subpixel, translate_first, tol,
                 K)) in enumerate(zip(rounds, meta)):
        origins = rd['origins']
        A1, b1 = _mesh1_block_affines(pos1.astype(jnp.float32),
                                      verts0_1.astype(jnp.float32),
                                      rd['tri_idx'])
        blocks0 = affine_warp_blocks_shifted(f0, origins, rd['A0'],
                                             rd['b0'], bs, bs, K)
        blocks1 = affine_warp_blocks_shifted(f1, origins, A1, b1, bs, bs, K)
        g0 = masked_dog_filter(blocks0, sigma)
        g1 = masked_dog_filter(blocks1, sigma)
        # chunk the FFTs at <=128 blocks, the classic path's
        # config.fft_batch, so both paths run the same rfft2 batch: an
        # rfft2 backend may choose a different decomposition at larger
        # batches, which once biased the quadratic subpixel fit
        # (chip_smoke.py's xcorr phase compares batch 256 with 128 on
        # the GPU). Under the batched
        # (vmapped) entry the TOTAL batch is pairs x chunk, so the caller
        # shrinks fft_chunk to keep the product <=128.
        n = blocks0.shape[0]
        chunk = min(int(fft_chunk), n)
        # overlap-envelope normalization for the FINAL (measured) round:
        # windowed correlation is multiplied by the overlap surface of
        # the blocks' valid-content masks, biasing even the EXACT peak
        # ~0.05-0.08 px toward zero displacement (measured). Blocks whose
        # whole source read window is interior (host-computed
        # rd['env_ok'] — affine corners +- (K+4) inside the sources'
        # valid extents) divide by the SHARED analytic full-block
        # envelope, which is exact for them; border blocks keep raw
        # peaks (a mismatched envelope measured 3x worse than none). Clamp
        # at 0.5 relative overlap bounds far-field noise amplification
        # at 2x. Only blocks >= 64 px: smaller peaks are noisy enough
        # that amplification outweighs the bias (measured 2x worse on
        # 16-48 px strip blocks, 4x better on 128 px interior ones).
        use_env = bool(env_norm) and bool(subpixel) and bs >= 64
        if use_env:
            Mk = jnp.fft.rfft2(jnp.ones((1, bs, bs), jnp.float32),
                               s=(fy, fx))
            Nc_env = jnp.conj(Mk) * Mk
            E = jnp.fft.irfft2(Nc_env, s=(fy, fx))
            env_div = jnp.clip(E / jnp.clip(E.max(), 1e-6, None), 0.5, None)
            env_ok = rd['env_ok']
        dxs, dys, confs = [], [], []
        for s in range(0, n, chunk):
            F0 = jnp.fft.rfft2(g0[s:s + chunk], s=(fy, fx))
            F1 = jnp.fft.rfft2(g1[s:s + chunk], s=(fy, fx))
            Fc = jnp.conj(F0) * F1
            C = jnp.fft.irfft2(Fc, s=(fy, fx))
            if use_env:
                okc = env_ok[s:s + chunk][:, None, None]
                C_pk = jnp.where(okc > 0, C / env_div, C)
                Nc_c = Nc_env
            else:
                C_pk = C
                Nc_c = None
            # peaks localize on the envelope-normalized surface; the
            # confidence ratio stays on the RAW surfaces (normalizing
            # both deflates conf ~2x and breaks tuned thresholds)
            dx_c, dy_c, _peak = _peak_and_subpixel(C_pk, (fy, fx),
                                                   subpixel, Fc=Fc,
                                                   Nc=Nc_c)
            Cm = jnp.abs(jnp.fft.irfft2(F0 * F1, s=(fy, fx)))
            nc = C.shape[0]
            mx_rl = C.reshape(nc, -1).max(axis=-1)
            mx_mr = Cm.reshape(nc, -1).max(axis=-1)
            conf_c = jnp.where(
                mx_rl > 0, 1.0 - mx_mr / jnp.where(mx_rl > 0, mx_rl, 1.0),
                0.0)
            dxs.append(dx_c)
            dys.append(dy_c)
            confs.append(jnp.clip(conf_c, 0.0, 1.0))
        dx = jnp.concatenate(dxs)
        dy = jnp.concatenate(dys)
        conf = jnp.concatenate(confs)
        # recenter to the FFT torus (blocks share one shape)
        dy = dy - jnp.round(dy / fy) * fy
        dx = dx - jnp.round(dx / fx) * fx
        d = jnp.stack([dx, dy], axis=-1).astype(dt)
        w0 = jnp.where((conf >= conf_thresh) & (rd['valid'] > 0),
                       conf, 0.0).astype(dt)
        # xcorr convention: block1's content at c matches block0's at c-d
        targets = rd['centers'] - d
        idx_a = rd['anchor_idx']
        # anchors are the mesh1 material points sitting at the block
        # centers AT MEASUREMENT TIME: barycentrics against the CURRENT
        # positions (the classic path recomputes tid/bary per round; a
        # prep-frozen bary would lag the mesh by its accumulated motion)
        bary_a = _centered_bary(pos1[idx_a], rd['centers'])
        # mesh0-side anchor barycentrics (balance traces only): measured
        # targets against the locked mesh0 triangle under each block
        bary0_a = _centered_bary(pos0[rd['anchor_idx0']], targets)
        if translate_first:
            p1 = (pos1[idx_a] * bary_a[..., None]).sum(axis=1)
            wsum = jnp.clip(jnp.sum(w0 ** 2), 1e-12, None)
            t = jnp.sum((targets - p1) * (w0 ** 2)[:, None], axis=0) / wsum
            pos1 = pos1 + t
        w = w0
        for _p in range(huber_passes + 1):
            pos1 = _solve_round(pos1, shape1, Ke, tris1, nv, idx_a, bary_a,
                                w, targets, jnp.asarray(lam_ratio, dt), tol,
                                maxiter, dK0, rd['anchor_idx0'], bary0_a)
            if _p < huber_passes:
                p1 = (pos1[idx_a] * bary_a[..., None]).sum(axis=1)
                res = jnp.linalg.norm(p1 - targets, axis=-1)
                f = jnp.clip(rd['rlen'] / jnp.clip(res, 1e-9, None),
                             None, 1.0).astype(dt)
                w = w0 * f
        d_last, conf_last, w_last = d, conf.astype(dt), w
        bary_last = bary_a
    return jnp.concatenate([
        pos1, d_last, jnp.stack([conf_last, w_last], axis=-1),
        bary_last[:, :2], coarse_stats], axis=0)


fused_rounds = functools.partial(
    jax.jit,
    static_argnames=('meta', 'lam_ratio', 'sigma', 'conf_thresh',
                     'huber_passes', 'maxiter', 'coarse_meta',
                     'fft_chunk', 'env_norm'))(
    _fused_rounds_core)


@functools.partial(
    jax.jit,
    static_argnames=('meta', 'lam_ratio', 'sigma', 'conf_thresh',
                     'huber_passes', 'maxiter', 'coarse_meta', 'env_norm'))
def fused_rounds_batched(src0, src1, pos1, verts0_1, shape1, tris1,
                         multiplier, poisson, rounds, meta, shape0, tris0,
                         multiplier0, poisson0, pos0, lam_ratio=0.35,
                         sigma=2.5, conf_thresh=0.3, huber_passes=2,
                         maxiter=600, coarse=None, coarse_meta=None,
                         env_norm=True):
    """vmap of the fused schedule over a leading PAIR axis: a whole batch
    of same-shape tile pairs (one section's overlaps bucket to a handful
    of shapes) costs ONE dispatch and one fetch. All array arguments
    carry the pair axis; statics are shared."""
    n_pairs = src0.shape[0]
    fft_chunk = max(8, 128 // max(int(n_pairs), 1))

    def one(s0, s1, p1, v01, sh1, t1, ml, po, rds, sh0, t0_, ml0, po0, p0,
            crs):
        return _fused_rounds_core(
            s0, s1, p1, v01, sh1, t1, ml, po, rds, meta, sh0, t0_, ml0,
            po0, p0, lam_ratio=lam_ratio, sigma=sigma,
            conf_thresh=conf_thresh, huber_passes=huber_passes,
            maxiter=maxiter, coarse=crs, coarse_meta=coarse_meta,
            fft_chunk=fft_chunk, env_norm=env_norm)

    return jax.vmap(one)(src0, src1, pos1, verts0_1, shape1, tris1,
                         multiplier, poisson, rounds, shape0, tris0,
                         multiplier0, poisson0, pos0, coarse)
