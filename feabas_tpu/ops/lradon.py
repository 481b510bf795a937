"""Device thumbnail feature pipeline: DoG keypoint detection, local-Radon
descriptor extraction, and rotation-exhaustive descriptor matching as three
jitted programs (reference host pipeline: feabas/thumbnail.py:605-760).

Design notes:
- detection returns a STATIC top-k keypoint table (xy, response, valid) —
  data-dependent counts become a validity mask so one compiled program
  serves every section;
- LRadon extraction samples each keypoint's rotated beam window directly
  (one bilinear gather per sample): the rotate-the-canvas + box-blur
  formulation is linear, so the blur commutes with the sampling and the
  whole thing collapses to K*P*B*(D*wd) gathers independent of image
  size (see ``_lradon_core``); descriptors agree with the host path
  (feabas_tpu/thumbnail.py:125) to float tolerance;
- matching reduces on device: similarity over all 2P rotation variants,
  best-rotation selection, mutual-nearest check and ratio-test confidence
  all happen in-program, so the fetch is O(K) vectors, never the
  (R, N1, N0) similarity volume (192 MB at 2k keypoints through a
  54 MB/s link -- the old host reduction's hidden cost).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from feabas_tpu.constant import MATMUL_PRECISION
from feabas_tpu.ops.filters import gaussian_blur
from feabas_tpu.ops.warp import bilinear_sample


# ------------------------- detection ------------------------- #

def _detect_body(img, mask, sigma, size, k, has_mask):
    """Traced detect body (DoG + separable max-pool peaks + top-k +
    subpixel fit) — composable into larger fused programs."""
    import math
    s = float(sigma)
    f0 = gaussian_blur(img, s)
    f1 = gaussian_blur(f0, s)
    f = f0 - f1
    if has_mask:
        ptp = jnp.max(img) - jnp.min(img)
        mask_img = ptp * (mask == 0).astype(img.dtype)
        sc = math.sqrt(2.0) * s
        maskf = gaussian_blur(mask_img, sc) * (sc ** 2) / (s ** 2)
        f = jnp.clip(jnp.abs(f) - maskf, 0, None) * jnp.sign(f)
    f = jnp.abs(f)                      # both polarities, like the host path
    # local maxima: max-pool with -inf padding == maximum_filter with
    # replicate padding (the replicated values are copies of in-window
    # pixels, so both reduce over the window's valid intersection)
    # rectangular max filter is separable: two 1D passes cost 2*size
    # comparisons/px instead of size^2 (size is 10-16 in production)
    mx = jax.lax.reduce_window(f, -jnp.inf, jax.lax.max,
                               (size, 1), (1, 1), 'SAME')
    mx = jax.lax.reduce_window(mx, -jnp.inf, jax.lax.max,
                               (1, size), (1, 1), 'SAME')
    peaks = (f >= mx) & (f > 0)
    if has_mask:
        peaks = peaks & (mask > 0)
    h, w = f.shape
    resp = jnp.where(peaks, f, -jnp.inf).ravel()
    vals, idx = jax.lax.top_k(resp, k)
    yy = idx // w
    xx = idx % w
    valid = jnp.isfinite(vals)
    # subpixel: 1D quadratic fit along each axis at interior peaks
    inner = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1) & valid
    yc = jnp.clip(yy, 1, h - 2)
    xc = jnp.clip(xx, 1, w - 2)
    c0 = f[yc, xc]
    cxx = f[yc, xc - 1] + f[yc, xc + 1] - 2 * c0
    cyy = f[yc - 1, xc] + f[yc + 1, xc] - 2 * c0
    ox = jnp.where(cxx < 0, (f[yc, xc - 1] - f[yc, xc + 1]) / (2 * cxx), 0.0)
    oy = jnp.where(cyy < 0, (f[yc - 1, xc] - f[yc + 1, xc]) / (2 * cyy), 0.0)
    xs = xx.astype(jnp.float32) + jnp.where(
        inner, jnp.clip(ox, -0.5, 0.5), 0.0)
    ys = yy.astype(jnp.float32) + jnp.where(
        inner, jnp.clip(oy, -0.5, 0.5), 0.0)
    return (jnp.stack([xs, ys], -1), jnp.where(valid, vals, 0.0), valid,
            yy, xx)


_detect_core = functools.partial(
    jax.jit, static_argnames=('sigma', 'size', 'k', 'has_mask'))(_detect_body)


def detect_log_device(img, mask=None, sigma=3.5, min_spacing=10,
                      num_features=5000):
    """Device DoG + local-max detection. Returns host arrays
    (xy (n, 2) f64, resp (n,), iyx (n, 2) int — integer peak locations for
    mask/class lookups), n <= num_features, response-sorted descending."""
    img = jnp.asarray(np.asarray(img, np.float32))
    has_mask = mask is not None
    m = jnp.asarray(np.asarray(mask, np.float32)) if has_mask \
        else jnp.zeros((1, 1), jnp.float32)
    size = max(int(round(min_spacing)), 3)
    k = int(num_features) if num_features and num_features > 0 else 5000
    k = min(k, img.shape[0] * img.shape[1])
    xy, resp, valid, yy, xx = _detect_core(img, m, float(sigma), size, k,
                                           has_mask)
    valid = np.asarray(valid)
    n = int(valid.sum())
    return (np.asarray(xy, np.float64)[:n], np.asarray(resp)[:n],
            np.stack([np.asarray(yy)[:n], np.asarray(xx)[:n]], -1))


# ------------------------- LRadon descriptors ------------------------- #

@functools.partial(jax.jit, static_argnames=('proj_num', 'beam_num',
                                             'beam_wd', 'D'))
def _lradon_core(img, xy, offs, proj_num, beam_num, beam_wd, D):
    """Direct per-keypoint LRadon sampling.

    The canvas formulation (rotate the whole image per angle, box-blur,
    sample) algebraically reduces to: descriptor(k, t, b) = mean of
    image samples at ``xy_k + R(t) @ (a, offs_b + v)`` over the beam
    window (a in -r..r along the beam, v over the beam width) — bilinear
    interpolation and the box filter are both linear, so the blur
    commutes with the sampling and the rotation collapses into the
    per-sample coordinates. Cost is K*P*B*(D*wd) gathers, INDEPENDENT of
    image size (the canvas path rotated + cumsummed a pow2 diagonal
    canvas per angle). It is gather-bound, which is why production
    routes through ``_lradon_patch_core`` (the matmul path); this
    single-interpolation form is kept as the exactness reference the
    patch path is tested against.
    """
    h, w = img.shape
    t = jnp.arange(proj_num) * (np.pi / proj_num)
    c = jnp.cos(t)
    s = jnp.sin(t)
    r = (D - 1) // 2
    a = jnp.arange(D, dtype=jnp.float32) - r              # along beam
    v = jnp.arange(beam_wd, dtype=jnp.float32) - (beam_wd - 1) / 2.0
    bp = offs[:, None] + v[None, :]                       # (B, wd)

    def one_angle(ci, si):
        # window offsets in image coords: R @ (a, b')
        dx = a[:, None, None] * ci + bp[None, :, :] * si  # (D, B, wd)
        dy = -a[:, None, None] * si + bp[None, :, :] * ci
        px = xy[:, 0][:, None, None, None] + dx[None]     # (K, D, B, wd)
        py = xy[:, 1][:, None, None, None] + dy[None]
        # replicate border, as the canvas rotate did
        px = jnp.clip(px, 0.0, w - 1.0)
        py = jnp.clip(py, 0.0, h - 1.0)
        return bilinear_sample(img, px, py, 0.0).mean(axis=(1, 3))

    des = jax.vmap(one_angle)(c, s)            # (P, K, B)
    des = jnp.transpose(des, (1, 0, 2))        # (K, P, B)
    des = des - des.mean(axis=(1, 2), keepdims=True)
    nrm = jnp.linalg.norm(des.reshape(des.shape[0], -1), axis=-1)
    return des / jnp.clip(nrm, 1e-6, None)[:, None, None]


_STENCIL_CACHE = {}


def _stencil_table(proj_num, beam_num, beam_wd, D, offs, Rp):
    """(4, P*B, Dp*Dp) f32 sampling-stencil matrix, host-precomputed.

    Row (t*B + b) of corner plane c = (cy, cx) holds the mean bilinear
    stencil of the beam window's D*wd taps at patch positions
    ``(Rp, Rp) + R(t) @ (a, offs_b + v) + (cx, cy)`` — i.e. the LRadon
    bin evaluated on the integer-corner-shifted patch. The descriptor at
    a fractional keypoint offset is the bilinear blend of the four
    corner evaluations (same double-interpolation class as the host
    path's rotate-canvas-then-sample)."""
    key = (proj_num, beam_num, beam_wd, D, Rp, offs.tobytes())
    if key in _STENCIL_CACHE:
        return _STENCIL_CACHE[key]
    Dp = 2 * Rp + 1
    r = (D - 1) // 2
    a = np.arange(D, dtype=np.float64) - r
    v = np.arange(beam_wd, dtype=np.float64) - (beam_wd - 1) / 2.0
    bp = offs[:, None].astype(np.float64) + v[None, :]        # (B, wd)
    W = np.zeros((2, 2, proj_num * beam_num, Dp * Dp), np.float64)
    for it in range(proj_num):
        th = it * (np.pi / proj_num)
        ci, si = np.cos(th), np.sin(th)
        dx = a[:, None, None] * ci + bp[None] * si            # (D, B, wd)
        dy = -a[:, None, None] * si + bp[None] * ci
        for cy in (0, 1):
            for cx in (0, 1):
                px = dx + Rp + cx
                py = dy + Rp + cy
                x0 = np.floor(px).astype(np.int64)
                y0 = np.floor(py).astype(np.int64)
                fx = px - x0
                fy = py - y0
                assert x0.min() >= 0 and y0.min() >= 0 \
                    and x0.max() + 1 < Dp and y0.max() + 1 < Dp
                for xx, yy, ww in ((x0, y0, (1 - fx) * (1 - fy)),
                                   (x0 + 1, y0, fx * (1 - fy)),
                                   (x0, y0 + 1, (1 - fx) * fy),
                                   (x0 + 1, y0 + 1, fx * fy)):
                    flat = yy * Dp + xx                       # (D, B, wd)
                    for b in range(beam_num):
                        np.add.at(W[cy, cx, it * beam_num + b],
                                  flat[:, b, :].ravel(),
                                  ww[:, b, :].ravel() / (D * beam_wd))
    W = jnp.asarray(W.reshape(4, proj_num * beam_num, Dp * Dp), jnp.float32)
    _STENCIL_CACHE[key] = W
    return W


def _patch_body(imgp, z, f, W, proj_num, Rp):
    """Traced patch + stencil-matmul LRadon evaluation (matmul path).

    The direct formulation (``_lradon_core``) costs K*P*B*D*wd bilinear
    gathers — gather-bound at ~100M reads/s (2.4 s at 8k keypoints).
    Every tap lives within a fixed (Dp, Dp) window of the keypoint, so:
    slice one patch per keypoint (contiguous dynamic_slice rows, not
    element gathers), then evaluate ALL P*B bins of all 4 integer-corner
    shifts as ONE matmul against the precomputed stencil matrix and
    blend the corners with the keypoint's fractional offset. The
    sampling moves from gathers to one matmul: (K, Dp^2) @ (Dp^2,
    4*P*B) ~ 7 GFLOP at 8k keypoints."""
    Dp = 2 * Rp + 1
    patches = jax.vmap(
        lambda zk: jax.lax.dynamic_slice(imgp, (zk[1], zk[0]), (Dp, Dp)))(z)
    Pm = patches.reshape(patches.shape[0], -1)                # (K, Dp^2)
    M = jnp.einsum('kp,cqp->kcq', Pm, W,
                   precision=MATMUL_PRECISION)       # (K, 4, PB)
    fx, fy = f[:, 0], f[:, 1]
    wc = jnp.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                    (1 - fx) * fy, fx * fy], axis=1)          # (K, 4)
    des = jnp.einsum('kc,kcq->kq', wc, M, precision=MATMUL_PRECISION)
    des = des.reshape(des.shape[0], proj_num, -1)             # (K, P, B)
    des = des - des.mean(axis=(1, 2), keepdims=True)
    nrm = jnp.linalg.norm(des.reshape(des.shape[0], -1), axis=-1)
    return des / jnp.clip(nrm, 1e-6, None)[:, None, None]


_lradon_patch_core = functools.partial(
    jax.jit, static_argnames=('proj_num', 'Rp'))(_patch_body)


def _desc_params(proj_num, beam_num, beam_wd, beam_radius):
    """Shared descriptor geometry: beam box width D, the beam offsets,
    and the patch radius Rp that contains every rotated tap."""
    r = float(beam_radius)
    D = 2 * int(round(r)) + 1
    ax = np.linspace(-r, r, D)
    idx = np.linspace(0, D - 1, beam_num).round().astype(np.int64)
    offs = np.asarray(ax[idx], np.float32)
    wd_half = (beam_wd - 1) / 2.0
    Rp = int(np.ceil(np.hypot(r, np.abs(ax[idx]).max() + wd_half))) + 2
    return D, offs, Rp


def lradon_descriptors_device(img, xy, proj_num=6, beam_num=8, beam_wd=3,
                              beam_radius=15):
    """Device LRadon descriptors for keypoints ``xy`` (n, 2).
    Returns a device (n_pad, P, B) f32 array and n (callers slice)."""
    imgh = np.asarray(img, np.float32)
    h, w = imgh.shape
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    n = int(np.asarray(xy).shape[0])
    # pad the keypoint count to pow2 buckets so compiled signatures are
    # shared across sections
    n_pad = max(64, 1 << (n - 1).bit_length()) if n else 64
    xyp = np.zeros((n_pad, 2), np.float32)
    if n:
        # clamp into the image like the direct sampler's coordinate clip
        xyp[:n] = np.clip(np.asarray(xy, np.float32),
                          0.0, [w - 1.0, h - 1.0])
    # replicate-pad so every patch slice is in-bounds; edge padding
    # reproduces the direct sampler's clip-into-image border rule
    pad = Rp + 1
    imgp = np.pad(imgh, pad, mode='edge')
    z0 = np.floor(xyp)
    f = jnp.asarray(xyp - z0, jnp.float32)
    z = jnp.asarray(z0.astype(np.int32) + (pad - Rp), jnp.int32)
    W = _stencil_table(int(proj_num), int(beam_num), int(beam_wd), D,
                       offs, Rp)
    des = _lradon_patch_core(jnp.asarray(imgp), z, f, W, int(proj_num), Rp)
    return des, n


# ------------------------- matching ------------------------- #

def _variants(des, proj_num):
    """(2P, K, P*B) rotation variants on device: rotating the image by
    k*pi/P cyclically shifts projections (flipping the offset axis past
    the wrap); the second P variants add a half-turn (full flip)."""
    k0 = des.shape[0]
    base = [des, des[:, :, ::-1]]
    out = []
    for b in base:
        for k in range(proj_num):
            rolled = jnp.roll(b, -k, axis=1)
            if k > 0:
                rolled = jnp.concatenate(
                    [rolled[:, :proj_num - k],
                     rolled[:, proj_num - k:, ::-1]], axis=1)
            out.append(rolled.reshape(k0, -1))
    return jnp.stack(out)


def _match_body(d0, v0, d1, v1, proj_num, exhaustive):
    """Traced masked matching body: v0/v1 are (K,) bool validity masks
    (valid & active), so the SAME device-resident descriptor sets serve
    every robustness round — later rounds upload two bool vectors, not
    re-padded descriptor copies. The rotation search scans variants with
    a running-best (K1, K0) plane: peak memory is one similarity plane,
    never the (2P, K1, K0) volume."""
    k0 = d0.shape[0]
    k1 = d1.shape[0]
    a0 = d0.reshape(k0, -1)
    vmask = v1[:, None] & v0[None, :]
    if exhaustive:
        variants = _variants(d1, proj_num)          # (R, K1, PB)

        def step(carry, vr):
            S_best, m_best, r_best, ri = carry
            S = jnp.einsum('nd,md->nm', vr, a0,
                           precision=MATMUL_PRECISION)
            S = jnp.where(vmask, S, -jnp.inf)
            m = jnp.max(S)
            take = m > m_best                        # first max wins ties
            return (jnp.where(take, S, S_best), jnp.where(take, m, m_best),
                    jnp.where(take, ri, r_best), ri + 1), None

        init = (jnp.full((k1, k0), -jnp.inf, jnp.float32),
                -jnp.inf, jnp.int32(0), jnp.int32(0))
        (S, _, best_rot, _), _ = jax.lax.scan(step, init, variants)
    else:
        S = jnp.einsum('nd,md->nm', d1.reshape(k1, -1), a0,
                       precision=MATMUL_PRECISION)
        S = jnp.where(vmask, S, -jnp.inf)
        best_rot = jnp.int32(0)
    i0 = jnp.argmax(S, axis=1)                       # (K1,)
    top = jnp.max(S, axis=1)
    S2 = jnp.where(jax.nn.one_hot(i0, k0, dtype=bool), -jnp.inf, S)
    second = jnp.max(S2, axis=1)
    back = jnp.argmax(S, axis=0)                     # (K0,)
    mutual = back[i0] == jnp.arange(k1)
    conf = jnp.where(top > 0,
                     1 - jnp.clip(second, 0, None)
                     / jnp.clip(top, 1e-6, None), 0.0)
    return i0, top, conf, mutual & v1, best_rot


@functools.partial(jax.jit, static_argnames=('proj_num', 'exhaustive'))
def _match_core(d0, n0, d1, n1, proj_num, exhaustive):
    v0 = jnp.arange(d0.shape[0]) < n0
    v1 = jnp.arange(d1.shape[0]) < n1
    return _match_body(d0, v0, d1, v1, proj_num, exhaustive)


_match_core_masked = functools.partial(
    jax.jit, static_argnames=('proj_num', 'exhaustive'))(_match_body)


def match_lradon_device(des0, n0, des1, n1, exhaustive=True,
                        conf_thresh=0.5):
    """Mutual-nearest descriptor matching with the reduction on device.
    des0/des1: (K_pad, P, B) device arrays from
    ``lradon_descriptors_device``. Returns (idx0, idx1, conf, best_rot)
    exactly like the host ``match_LRadon_feature``."""
    if n0 == 0 or n1 == 0:
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0), 0)
    proj_num = int(des0.shape[1])
    i0, top, conf, mutual, best_rot = _match_core(
        des0, np.int32(n0), des1, np.int32(n1), proj_num, bool(exhaustive))
    i0 = np.asarray(i0)[:n1]
    top = np.asarray(top)[:n1]
    conf = np.asarray(conf)[:n1]
    mutual = np.asarray(mutual)[:n1]
    keep = mutual & (conf > conf_thresh) & (top > 0.1)
    i1 = np.arange(n1)
    return i0[keep], i1[keep], conf[keep], int(best_rot)


def _match_postprocess(i0, top, conf, mutual, best_rot, conf_thresh):
    """Shared host-side thresholding of a raw device match. ``mutual``
    already carries the side-1 validity/active mask, so the surviving
    indices are GLOBAL rows of the (padded) descriptor arrays."""
    i0 = np.asarray(i0)
    top = np.asarray(top)
    conf = np.asarray(conf)
    mutual = np.asarray(mutual)
    keep = mutual & (conf > conf_thresh) & (top > 0.1)
    i1 = np.nonzero(keep)[0]
    return i0[keep], i1, conf[keep], int(best_rot)


def match_lradon_device_masked(des0_dev, m0, des1_dev, m1, exhaustive=True,
                               conf_thresh=0.5):
    """Mutual-nearest matching on DEVICE-RESIDENT descriptor sets with
    host bool masks (valid & still-active). Per robustness round this
    uploads two (K,) bool vectors and fetches O(K) result vectors — the
    descriptors never leave the device. Returns GLOBAL indices
    (idx0, idx1, conf, best_rot) into the padded descriptor rows."""
    if not m0.any() or not m1.any():
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0), 0)
    proj_num = int(des0_dev.shape[1])
    i0, top, conf, mutual, best_rot = _match_core_masked(
        des0_dev, jnp.asarray(np.asarray(m0, bool)),
        des1_dev, jnp.asarray(np.asarray(m1, bool)),
        proj_num, bool(exhaustive))
    return _match_postprocess(i0, top, conf, mutual, best_rot, conf_thresh)


# ------------------- fused feature / pair programs ------------------- #
#
# The staged flow paid ~6 serialized dispatch+fetch round trips per
# thumbnail pair (detect x2, xy fetch x2, describe x2, match x rounds).
# The fused flow pays TWO:
#   dispatch A (_detect_prep): DoG detect + patch-origin prep + class
#     lookup for BOTH images in one program; only the tiny keypoint
#     tables fetch (the images and per-keypoint z/f tables stay on
#     device as the program's input/output handles);
#   dispatch B (_desc_match): descriptors for both images at an
#     ADAPTIVE pow2 bucket of the detected counts (static top-k slices
#     of A's response-sorted outputs) + the round-0 rotation-exhaustive
#     match. A single static descriptor count would instead burn
#     K=num_features worth of patch gathers and similarity FLOPs on
#     mostly-padding rows (measured 2.6x slower at 5k cap / 1k real).
# Later robustness rounds reuse the device-resident descriptors through
# ``match_lradon_device_masked`` (one round trip each).

def _detect_prep_body(img, mask, sigma, size, k, has_mask, Rp):
    """Traced detect + descriptor-prep for one image: keypoints, their
    patch origins z / fractional offsets f (in the edge-padded frame the
    descriptor stage uses), and region class ids."""
    xy, resp, valid, yy, xx = _detect_body(img, mask, sigma, size, k,
                                           has_mask)
    h, w = img.shape
    # clamp into the image exactly like the host descriptor prep
    # (lradon_descriptors_device)
    xyc = jnp.clip(xy, 0.0, jnp.asarray([w - 1.0, h - 1.0], jnp.float32))
    z0 = jnp.floor(xyc)
    f = (xyc - z0).astype(jnp.float32)
    pad = Rp + 1
    z = z0.astype(jnp.int32) + (pad - Rp)
    if has_mask:
        cls = mask[yy, xx].astype(jnp.int32)
    else:
        cls = jnp.zeros(yy.shape[0], jnp.int32)
    return xy, resp, valid, yy, xx, cls, z, f


_detect_prep_core = functools.partial(
    jax.jit, static_argnames=('sigma', 'size', 'k', 'has_mask',
                              'Rp'))(_detect_prep_body)


@functools.partial(jax.jit,
                   static_argnames=('sigma', 'size', 'k0', 'k1',
                                    'has_mask0', 'has_mask1', 'Rp'))
def _pair_detect_core(img0, mask0, img1, mask1, sigma, size, k0, k1,
                      has_mask0, has_mask1, Rp):
    return (_detect_prep_body(img0, mask0, sigma, size, k0, has_mask0, Rp),
            _detect_prep_body(img1, mask1, sigma, size, k1, has_mask1, Rp))


@functools.partial(jax.jit, static_argnames=('kd', 'proj_num', 'Rp'))
def _desc_core(img, z, f, W, kd, proj_num, Rp):
    """Descriptors for the top-``kd`` (response-sorted) keypoints of one
    image; img / z / f are device residents from the detect dispatch."""
    imgp = jnp.pad(img, Rp + 1, mode='edge')
    return _patch_body(imgp, z[:kd], f[:kd], W, proj_num, Rp)


@functools.partial(jax.jit,
                   static_argnames=('kd0', 'kd1', 'proj_num', 'Rp',
                                    'exhaustive'))
def _pair_desc_match_core(img0, z0, f0, v0, img1, z1, f1, v1, W, kd0, kd1,
                          proj_num, Rp, exhaustive):
    des0 = _desc_core(img0, z0, f0, W, kd0, proj_num, Rp)
    des1 = _desc_core(img1, z1, f1, W, kd1, proj_num, Rp)
    m = _match_body(des0, v0[:kd0], des1, v1[:kd1], proj_num, exhaustive)
    return des0, des1, m


def _detect_statics(img, sigma, min_spacing, num_features):
    size = max(int(round(min_spacing)), 3)
    k = int(num_features) if num_features and num_features > 0 else 5000
    k = min(k, int(np.asarray(img).size))
    return float(sigma), size, k


def _kd_bucket(n, k):
    """pow2 descriptor bucket covering the n detected keypoints (never
    drops one: n <= k always, and min(pow2(n), k) >= n)."""
    return int(min(max(64, 1 << max(int(n) - 1, 0).bit_length()), k))


def _detect_fetch(out, k):
    """Host-side unpack of one image's detect outputs (small tables);
    device handles (z, f, valid) ride along for the descriptor stage."""
    xy, resp, valid, yy, xx, cls, z, f = out
    vh = np.asarray(valid)
    n = int(vh.sum())             # top-k sorts invalid (-inf) last
    return {
        'xy': np.asarray(xy, np.float64)[:n],
        'resp': np.asarray(resp)[:n],
        'iyx': np.stack([np.asarray(yy)[:n], np.asarray(xx)[:n]], -1),
        'cls': np.asarray(cls)[:n],
        'n': n, 'k': int(k),
        '_z': z, '_f': f, '_v': valid,
    }


def features_device(img, mask=None, sigma=3.5, min_spacing=10,
                    num_features=5000, proj_num=6, beam_num=8, beam_wd=3,
                    beam_radius=15):
    """Two-dispatch detect + describe for one image (detect-prep, then
    descriptors at the adaptive bucket). Returns a dict with host
    keypoint tables (xy/resp/iyx/cls, response-sorted, length n) and the
    device-resident (kd, P, B) descriptor array ``des_dev`` (rows past n
    are padding; pair it with a ``valid & active`` mask for
    ``match_lradon_device_masked``)."""
    imgf = np.asarray(img, np.float32)
    has_mask = mask is not None
    m = np.asarray(mask, np.float32) if has_mask \
        else np.zeros((1, 1), np.float32)
    sigma, size, k = _detect_statics(imgf, sigma, min_spacing, num_features)
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    W = _stencil_table(int(proj_num), int(beam_num), int(beam_wd), D,
                       offs, Rp)
    img_dev = jnp.asarray(imgf)
    out = _detect_prep_core(img_dev, jnp.asarray(m), sigma, size, k,
                            has_mask, Rp)
    feat = _detect_fetch(out, k)
    kd = _kd_bucket(feat['n'], k)
    des = _desc_core(img_dev, feat.pop('_z'), feat.pop('_f'), W, kd,
                     int(proj_num), Rp)
    feat.pop('_v')
    feat['des_dev'] = des
    feat['des'] = np.asarray(des)[:feat['n']]
    return feat


def pair_features_device(img0, img1, mask0=None, mask1=None, sigma=3.5,
                         min_spacing=10, num_features=5000, proj_num=6,
                         beam_num=8, beam_wd=3, beam_radius=15,
                         exhaustive=True, conf_thresh=0.5):
    """Detect + describe BOTH images and run the round-0 match in TWO
    dispatches (fused pair detect, then bucketed pair describe+match).
    Returns (feat0, feat1, (idx0, idx1, conf, best_rot)) where featN are
    ``features_device``-shaped dicts and the indices are global keypoint
    rows."""
    img0 = np.asarray(img0, np.float32)
    img1 = np.asarray(img1, np.float32)
    hm0 = mask0 is not None
    hm1 = mask1 is not None
    m0 = np.asarray(mask0, np.float32) if hm0 \
        else np.zeros((1, 1), np.float32)
    m1 = np.asarray(mask1, np.float32) if hm1 \
        else np.zeros((1, 1), np.float32)
    sigma, size, k0 = _detect_statics(img0, sigma, min_spacing,
                                      num_features)
    _, _, k1 = _detect_statics(img1, sigma, min_spacing, num_features)
    D, offs, Rp = _desc_params(proj_num, beam_num, beam_wd, beam_radius)
    W = _stencil_table(int(proj_num), int(beam_num), int(beam_wd), D,
                       offs, Rp)
    d0 = jnp.asarray(img0)
    d1 = jnp.asarray(img1)
    o0, o1 = _pair_detect_core(d0, jnp.asarray(m0), d1, jnp.asarray(m1),
                               sigma, size, k0, k1, hm0, hm1, Rp)
    feat0 = _detect_fetch(o0, k0)
    feat1 = _detect_fetch(o1, k1)
    kd0 = _kd_bucket(feat0['n'], k0)
    kd1 = _kd_bucket(feat1['n'], k1)
    des0, des1, m = _pair_desc_match_core(
        d0, feat0.pop('_z'), feat0.pop('_f'), feat0.pop('_v'),
        d1, feat1.pop('_z'), feat1.pop('_f'), feat1.pop('_v'),
        W, kd0, kd1, int(proj_num), Rp, bool(exhaustive))
    feat0['des_dev'] = des0
    feat0['des'] = np.asarray(des0)[:feat0['n']]
    feat1['des_dev'] = des1
    feat1['des'] = np.asarray(des1)[:feat1['n']]
    match = _match_postprocess(*m, conf_thresh=conf_thresh)
    return feat0, feat1, match
