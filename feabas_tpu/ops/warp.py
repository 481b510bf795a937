"""Device image warping: bilinear gather sampling and per-block affine
warps.

The matcher's hot loop renders thousands of small blocks through deforming
meshes. On device this becomes: per-block affine maps (from the triangle
under each block center — the reference's RENDER_LOCAL_AFFINE
approximation, ``feabas/renderer.py:94-109``) + one batched bilinear
gather from the device-resident source image. Combined with the xcorr
kernel, a whole match round is a single XLA program; only block centers
and peak results cross the host boundary.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def bilinear_sample(img, xs, ys, fillval=0.0):
    """Sample img (H, W) at float coords (broadcastable arrays);
    out-of-range -> fillval."""
    H, W = img.shape
    x0i = jnp.floor(xs).astype(jnp.int32)
    y0i = jnp.floor(ys).astype(jnp.int32)
    valid = (xs >= 0) & (ys >= 0) & (xs <= W - 1) & (ys <= H - 1)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)
    # fractions vs the CLAMPED base so xs == W-1 reads img[..., W-1]
    # (fx=1 there), not img[..., W-2]
    fx = xs - x0c.astype(xs.dtype)
    fy = ys - y0c.astype(ys.dtype)
    Ia = img[y0c, x0c]
    Ib = img[y0c, x0c + 1]
    Ic = img[y0c + 1, x0c]
    Id = img[y0c + 1, x0c + 1]
    out = (Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy)
           + Ic * (1 - fx) * fy + Id * fx * fy)
    return jnp.where(valid, out, fillval)


@jax.jit
def pack_u8_quads(src):
    """Pack each pixel's 2x2 bilinear neighborhood of a uint8 image into
    one uint32: packed[y, x] = img[y, x] | img[y, x+1] << 8
    | img[y+1, x] << 16 | img[y+1, x+1] << 24 (edge-clamped).

    Bilinear sampling then needs ONE gather per output pixel instead of
    four, which quarters the gather traffic for uint8 sources.
    """
    s = src.astype(jnp.uint32)
    sr = jnp.concatenate([s[:, 1:], s[:, -1:]], axis=1)       # x+1
    sd = jnp.concatenate([s[1:, :], s[-1:, :]], axis=0)       # y+1
    sdr = jnp.concatenate([sd[:, 1:], sd[:, -1:]], axis=1)    # x+1, y+1
    return s | (sr << 8) | (sd << 16) | (sdr << 24)


def bilinear_sample_packed(packed, xs, ys, fillval=0.0):
    """Bilinear sample from a ``pack_u8_quads`` image: one gather per
    pixel, neighbors unpacked with bit ops."""
    H, W = packed.shape
    x0i = jnp.floor(xs).astype(jnp.int32)
    y0i = jnp.floor(ys).astype(jnp.int32)
    valid = (xs >= 0) & (ys >= 0) & (xs <= W - 1) & (ys <= H - 1)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)
    fx = xs - x0c.astype(xs.dtype)
    fy = ys - y0c.astype(ys.dtype)
    q = packed[y0c, x0c]
    Ia = (q & 0xff).astype(jnp.float32)
    Ib = ((q >> 8) & 0xff).astype(jnp.float32)
    Ic = ((q >> 16) & 0xff).astype(jnp.float32)
    Id = (q >> 24).astype(jnp.float32)
    out = (Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy)
           + Ic * (1 - fx) * fy + Id * fx * fy)
    return jnp.where(valid, out, fillval)


@jax.jit
def _remap_jit(img, xs, ys, fillval):
    return bilinear_sample(img.astype(jnp.float32), xs, ys, fillval)


def _p2(n, lo=64):
    return max(lo, 1 << int(max(n, 1) - 1).bit_length())


def remap_device(src, mxs, mys, fillval=0.0):
    """Device bilinear remap (cv2.remap equivalent) with pow2 shape
    bucketing so a handful of jit signatures serve arbitrary block sizes.

    The device option for the host render path: the gather runs the
    remap in device memory; callers choose via
    ``render_by_subregions(device_remap=...)``.
    Source ships in its native dtype (uint8 quarters transfer bytes).
    """
    import numpy as np
    H, W = src.shape[:2]
    h, w = mxs.shape
    Hp, Wp = _p2(H), _p2(W)
    hp, wp = _p2(h), _p2(w)
    src_p = np.pad(src, ((0, Hp - H), (0, Wp - W)), mode='edge')
    mx_p = np.full((hp, wp), -10.0, np.float32)
    my_p = np.full((hp, wp), -10.0, np.float32)
    mx_p[:h, :w] = mxs
    my_p[:h, :w] = mys
    # clamp into the REAL source domain so edge padding never bleeds
    np.clip(mx_p[:h, :w], None, W - 1, out=mx_p[:h, :w])
    np.clip(my_p[:h, :w], None, H - 1, out=my_p[:h, :w])
    out = _remap_jit(jnp.asarray(src_p), jnp.asarray(mx_p),
                     jnp.asarray(my_p), float(fillval))
    return np.asarray(out)[:h, :w]


@functools.partial(jax.jit, static_argnames=('block_h', 'block_w'))
def affine_warp_blocks(img, origins, A, b, block_h, block_w, fillval=0.0):
    """Render N blocks of (block_h, block_w) output pixels.

    Output pixel (y, x) of block n sits at world p = origins[n] + (x, y);
    its source coordinate is p @ A[n] + b[n] (row-vector affine). Returns
    (N, block_h, block_w) float32.
    """
    img = img.astype(jnp.float32)
    gx, gy = jnp.meshgrid(jnp.arange(block_w, dtype=jnp.float32),
                          jnp.arange(block_h, dtype=jnp.float32))

    def one(origin, An, bn):
        px = gx + origin[0]
        py = gy + origin[1]
        sx = px * An[0, 0] + py * An[1, 0] + bn[0]
        sy = px * An[0, 1] + py * An[1, 1] + bn[1]
        return bilinear_sample(img, sx, sy, fillval)

    return jax.vmap(one)(origins.astype(jnp.float32),
                         A.astype(jnp.float32), b.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=('h', 'w', 'K'))
def affine_warp_blocks_shifted(img, origins, A, b, h, w, K, fillval=0.0):
    """Gather-free batched affine block warp.

    XLA lowers ``bilinear_sample``'s advanced indexing to a per-element
    gather. Here each block slices ONE (h+2K+2, w+2K+2) source window at
    its integer base offset; the within-window source coordinate deviates
    from the output pixel by frac + (x,y)@(A-I), bounded by K, so
    bilinear sampling becomes a (2K+2)^2 static-shift weighted sum of
    elementwise math.

    K must bound ceil(max |(x,y)@(A-I)| + 1) over the block; pixels whose
    deviation exceeds K fall to ``fillval`` (zero weight on every shift),
    the same graceful failure as sampling outside the image.
    """
    H, W = img.shape
    imgf = img.astype(jnp.float32)
    # pad by a whole block so partially-overlapping border blocks never
    # hit dynamic_slice's start clamping (which would misalign the
    # window); fully-outside blocks clamp but every pixel is masked
    P = K + 2 + max(h, w)
    imgp = jnp.pad(imgf, P, constant_values=fillval)
    gx, gy = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32),
                          jnp.arange(h, dtype=jnp.float32))

    def one(origin, An, bn):
        base = jnp.stack([origin[0] * An[0, 0] + origin[1] * An[1, 0] + bn[0],
                          origin[0] * An[0, 1] + origin[1] * An[1, 1] + bn[1]])
        base_i = jnp.floor(base).astype(jnp.int32) - K
        base_i = jnp.clip(base_i, -P, jnp.asarray([W, H]) + P
                          - jnp.asarray([w, h]) - 2 * K - 2)
        win = jax.lax.dynamic_slice(
            imgp, (base_i[1] + P, base_i[0] + P),
            (h + 2 * K + 2, w + 2 * K + 2))
        sx = base[0] + gx * An[0, 0] + gy * An[1, 0]
        sy = base[1] + gx * An[0, 1] + gy * An[1, 1]
        rx = sx - base_i[0].astype(jnp.float32)
        ry = sy - base_i[1].astype(jnp.float32)
        ixf = jnp.floor(rx)
        iyf = jnp.floor(ry)
        fxv = rx - ixf
        fyv = ry - iyf
        # shift offsets relative to the output pixel (window row y+dy
        # holds source row base_i1 + y + dy)
        ix = ixf.astype(jnp.int32) - gx.astype(jnp.int32)
        iy = iyf.astype(jnp.int32) - gy.astype(jnp.int32)
        out = jnp.zeros((h, w), jnp.float32)
        for dy in range(2 * K + 2):
            wy = (jnp.where(iy == dy, 1.0 - fyv, 0.0)
                  + jnp.where(iy == dy - 1, fyv, 0.0))
            row = jnp.zeros((h, w), jnp.float32)
            for dx in range(2 * K + 2):
                wx = (jnp.where(ix == dx, 1.0 - fxv, 0.0)
                      + jnp.where(ix == dx - 1, fxv, 0.0))
                row = row + wx * jax.lax.dynamic_slice(win, (dy, dx), (h, w))
            out = out + wy * row
        valid = (sx >= 0) & (sy >= 0) & (sx <= W - 1) & (sy <= H - 1)
        return jnp.where(valid, out, fillval)

    return jax.vmap(one)(origins.astype(jnp.float32), A.astype(jnp.float32),
                         b.astype(jnp.float32))


_K_BUCKETS = (2, 3, 4, 6, 8)


def shift_bound_K(A, h, w):
    """Smallest K bucket bounding the within-window deviation
    |(x,y)@(A-I)| + 1 over an (h, w) block, or None when no bucket fits
    (extreme deformation -> use the gather path)."""
    dev = np.abs(np.asarray(A) - np.eye(2))
    worst = float((dev[..., 0, :].max(axis=-1) * w
                   + dev[..., 1, :].max(axis=-1) * h).max()) if dev.size else 0.0
    need = int(np.ceil(worst + 1.0))
    for k in _K_BUCKETS:
        if need <= k:
            return k
    return None


def warp_blocks_auto(img, origins, A, b, h, w, fillval=0.0, K=None):
    """Batched affine block warp: shifted-window fast path when the
    deformation fits a K bucket, gather fallback otherwise."""
    if K is None:
        K = shift_bound_K(A, h, w)
    if K is None:
        return affine_warp_blocks(img, origins, A, b, h, w, fillval=fillval)
    return affine_warp_blocks_shifted(img, origins, A, b, h, w, int(K),
                                      fillval=fillval)


def mesh_blocks_device(mesh, image, centers, block_size, gear=None,
                       fillval=0.0, src_offset=(0.0, 0.0)):
    """Render equal-size blocks centered at world points through a mesh's
    deformation, on device, using the local-affine approximation.

    Args:
        mesh: feabas_tpu Mesh (MOVING = output frame, INITIAL = source).
        image: source image as a device or host array (INITIAL frame).
        centers: (N, 2) world coordinates of block centers.
    Returns:
        (stack (N, h, w) jnp.float32 device array, kept indices (M,)).
    Blocks whose center lies outside the mesh are dropped.
    """
    from feabas_tpu import constant as const
    if gear is None:
        gear = (const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL)
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    tid = mesh.tri_finder(centers, gear=gear[0], extrapolate=False)
    kept = np.nonzero(tid >= 0)[0]
    if kept.size == 0:
        h = w = int(round(block_size))
        return jnp.zeros((0, h, w), jnp.float32), kept
    A_all, b_all = mesh.triangle_affine_tform(gear0=gear[0], gear1=gear[1])
    A = A_all[tid[kept]]
    # source coords index `image`, whose pixel (0,0) sits at world
    # src_offset in the source gear frame
    b = b_all[tid[kept]] - np.asarray(src_offset, np.float64)
    h = w = int(round(block_size))
    origins = np.round(centers[kept] - [w / 2, h / 2])
    # pad the batch to a power of two so compiled shapes are reused
    n = kept.size
    nb = max(8, 1 << (int(n - 1).bit_length()))
    if nb > n:
        pad = nb - n
        A = np.concatenate([A, np.repeat(A[:1], pad, axis=0)])
        b = np.concatenate([b, np.repeat(b[:1], pad, axis=0)])
        origins = np.concatenate([origins, np.repeat(origins[:1], pad, axis=0)])
    stack = warp_blocks_auto(jnp.asarray(image), jnp.asarray(origins),
                             jnp.asarray(A), jnp.asarray(b), h, w,
                             fillval=float(fillval))
    return stack[:n], kept
