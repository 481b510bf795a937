"""Batched FFT cross-correlation on device — the matcher's hot kernel.

Computes per-pair displacement peaks with optional quadratic subpixel
refinement, overlap normalization, and a mirror-correlation confidence
score (behavioral parity with reference ``feabas/matcher.py:22-137``;
redesigned as a single fused XLA program over an (N, H, W) stack).

Shapes are static per call: the host rounds FFT sizes up to FFT-friendly
values and buckets batches, so jit caches stay small.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from feabas_tpu import constant as const

_FFT_SIZES = None


def good_fft_size(n, pow2=False):
    """Smallest size >= n that factors into 2,3,5 (or a power of two)."""
    n = int(n)
    if n <= 1:
        return 1
    if pow2:
        return 1 << (n - 1).bit_length()
    global _FFT_SIZES
    if _FFT_SIZES is None:
        sizes = set()
        p2 = 1
        while p2 <= (1 << 17):
            p3 = p2
            while p3 <= (1 << 17):
                p5 = p3
                while p5 <= (1 << 17):
                    sizes.add(p5)
                    p5 *= 5
                p3 *= 3
            p2 *= 2
        _FFT_SIZES = np.array(sorted(sizes))
    return int(_FFT_SIZES[np.searchsorted(_FFT_SIZES, n)])


def _dft_upsample_offsets(Fc, iy, ix, fftshp, kappa, halfspan=0.75,
                          Nc=None):
    """Subpixel peak offsets by local matrix-multiply DFT upsampling
    (Guizar-Sicairos local-DFT registration, rephrased as matmuls).

    The correlation surface near the integer peak is evaluated directly
    from the cross-power half-spectrum ``Fc`` (N, fy, fx//2+1) on a
    ``2*halfspan`` px window at 1/``kappa`` px spacing: a per-item phase
    ramp recenters the peak at the origin, then two SHARED small complex
    matmuls (P, fy) x (N, fy, fxh) x (fxh, P) produce the local surface —
    batched matmuls instead of per-item zoom-FFTs, which is what makes it
    effectively free next to the rfft2s. A final 3x3 quadratic fit at the
    fine spacing leaves ~bias/kappa residual (the plain quadratic fit's
    pull-to-integer bias is ~0.06 px at half-pixel phases, measured).
    ``Nc``: optional mask-overlap half-spectrum — the local surface is
    divided by the matching overlap surface, removing the triangular
    envelope bias of windowed correlation (~0.05-0.08 px toward zero
    displacement, measured; the exact peak is faithful to that bias, so
    upsampling WITHOUT normalizing is worse than the quadratic fit).
    Returns (oy, ox) in px relative to (iy, ix)."""
    n, fy = Fc.shape[0], fftshp[0]
    fx = fftshp[1]
    fxh = Fc.shape[-1]
    P = int(2 * round(halfspan * kappa) + 1)
    delta = (jnp.arange(P, dtype=jnp.float32) - (P - 1) / 2) / kappa
    ky = ((jnp.arange(fy) + fy // 2) % fy) - fy // 2        # signed freqs
    kx = jnp.arange(fxh)                                    # rfft: >= 0
    # hermitian doubling weights for the missing half-spectrum
    wx = jnp.full((fxh,), 2.0, jnp.float32)
    wx = wx.at[0].set(1.0)
    if fx % 2 == 0:
        wx = wx.at[-1].set(1.0)
    two_pi_i = 2j * jnp.pi
    phase_y = jnp.exp(two_pi_i * iy[:, None] * ky[None, :] / fy)  # (N, fy)
    phase_x = jnp.exp(two_pi_i * ix[:, None] * kx[None, :] / fx)  # (N, fxh)
    G = Fc * phase_y[:, :, None] * (phase_x * wx[None, :])[:, None, :]
    # the two small DFT matmuls run as real/imag parts (6 real matmuls)
    # so every contraction is a real f32 dot at the stated precision
    ay = 2 * jnp.pi * delta[:, None] * ky[None, :] / fy           # (P, fy)
    ax = 2 * jnp.pi * delta[:, None] * kx[None, :] / fx           # (P, fxh)
    Wyr, Wyi = jnp.cos(ay), jnp.sin(ay)
    Wxr, Wxi = jnp.cos(ax), jnp.sin(ax)
    # full f32 products are mandatory: a reduced-precision matmul (TF32
    # on the GPU's tensor cores) loses the DFT phase coherence that the
    # subpixel peak depends on
    ein = functools.partial(jnp.einsum, precision=const.MATMUL_PRECISION)

    def local_surface(S):
        Sr, Si = jnp.real(S), jnp.imag(S)
        Tr = ein('nkq,sq->nks', Sr, Wxr) - ein('nkq,sq->nks', Si, Wxi)
        Ti = ein('nkq,sq->nks', Sr, Wxi) + ein('nkq,sq->nks', Si, Wxr)
        return (ein('pk,nks->nps', Wyr, Tr)
                - ein('pk,nks->nps', Wyi, Ti))                    # (N, P, P)

    Cl = local_surface(G)
    if Nc is not None:
        Nl = local_surface(
            Nc * phase_y[:, :, None] * (phase_x * wx[None, :])[:, None, :])
        mx = jnp.max(Nl.reshape(n, -1), axis=-1)[:, None, None]
        Cl = Cl / jnp.clip(Nl, 0.5 * jnp.clip(mx, 1e-6, None), None)
    Cf = Cl.reshape(n, P * P)
    idx = jnp.argmax(Cf, axis=-1)
    py, px = idx // P, idx % P
    # 3x3 quadratic polish at the fine spacing (clamped to the window)
    py = jnp.clip(py, 1, P - 2)
    px = jnp.clip(px, 1, P - 2)
    g = jnp.stack([(py - 1) * P + px, (py + 1) * P + px,
                   py * P + px - 1, py * P + px + 1, py * P + px], -1)
    Ct = jnp.take_along_axis(Cf, g, axis=-1)
    cyy = Ct[:, 0] + Ct[:, 1] - 2 * Ct[:, 4]
    cxx = Ct[:, 2] + Ct[:, 3] - 2 * Ct[:, 4]
    oy_f = jnp.where(cyy < 0, (Ct[:, 0] - Ct[:, 1]) / (2 * cyy), 0.0)
    ox_f = jnp.where(cxx < 0, (Ct[:, 2] - Ct[:, 3]) / (2 * cxx), 0.0)
    oy_f = jnp.clip(oy_f, -0.5, 0.5)
    ox_f = jnp.clip(ox_f, -0.5, 0.5)
    oy = delta[py] + oy_f / kappa
    ox = delta[px] + ox_f / kappa
    return oy, ox


def _peak_and_subpixel(C, fftshp, subpixel, Fc=None, Nc=None):
    """argmax of (N, fy, fx) correlation surfaces + subpixel refinement.
    ``subpixel``: falsy = integer peak; True/1 = 3x3 quadratic fit;
    int >= 2 = local DFT upsampling at that factor (needs ``Fc``, the
    cross-power half-spectrum the surface came from).
    Returns (dx, dy, peak_val)."""
    n = C.shape[0]
    fy, fx = fftshp
    Cf = C.reshape(n, fy * fx)
    idx = jnp.argmax(Cf, axis=-1)
    peak = jnp.take_along_axis(Cf, idx[:, None], axis=-1)[:, 0]
    dy = (idx // fx).astype(jnp.float32)
    dx = (idx % fx).astype(jnp.float32)
    kappa = int(subpixel) if not isinstance(subpixel, bool) else 0
    if kappa >= 2 and Fc is not None and Nc is not None:
        # the upsampler needs the overlap normalizer: the exact raw peak
        # is FAITHFUL to the envelope bias, so unnormalized upsampling
        # measures worse than the quadratic fit — fall through to it
        oy, ox = _dft_upsample_offsets(Fc, dy, dx, fftshp, kappa, Nc=Nc)
        return dx + ox, dy + oy, peak
    if subpixel:
        iy = (idx // fx)[:, None] + jnp.array([-1, 0, 1])[None, :]
        ix = (idx % fx)[:, None] + jnp.array([-1, 0, 1])[None, :]
        iy = jnp.mod(iy, fy)
        ix = jnp.mod(ix, fx)
        flat = (iy[:, :, None] * fx + ix[:, None, :]).reshape(n, 9)
        Ct = jnp.take_along_axis(Cf, flat, axis=-1)  # row-major 3x3: [yy, xx]
        tx = (Ct[:, 5] - Ct[:, 3]) / 2
        ty = (Ct[:, 7] - Ct[:, 1]) / 2
        txx = Ct[:, 3] + Ct[:, 5] - 2 * Ct[:, 4]
        tyy = Ct[:, 7] + Ct[:, 1] - 2 * Ct[:, 4]
        txy = (Ct[:, 0] + Ct[:, 8] - Ct[:, 2] - Ct[:, 6]) / 4
        det = txx * tyy - txy * txy
        safe = det > 0
        det = jnp.where(safe, det, 1.0)
        ox = jnp.where(safe, -(tyy * tx - txy * ty) / det, 0.0)
        oy = jnp.where(safe, -(-txy * tx + txx * ty) / det, 0.0)
        dx = dx + jnp.clip(ox, -0.5, 0.5)
        dy = dy + jnp.clip(oy, -0.5, 0.5)
    return dx, dy, peak


def _normalizer_from(F, fftshp, clip=0.1):
    """Relative mask-overlap surface from its precomputed half-spectrum,
    clipped below at ``clip`` (bounds far-field amplification)."""
    fy, fx = fftshp
    NC = jnp.fft.irfft2(F, s=fftshp).reshape(-1, fy * fx)
    NC = NC / jnp.clip(NC.max(axis=-1, keepdims=True), 1.0, None)
    return jnp.clip(NC, clip, None)


def _normalizer(M0, M1, fftshp, conj0, clip=0.1):
    return _normalizer_from((jnp.conj(M0) if conj0 else M0) * M1,
                            fftshp, clip=clip)


@functools.partial(
    jax.jit,
    static_argnames=('fftshp', 'shp0', 'shp1', 'conf_mode', 'subpixel', 'normalize'))
def _xcorr_core(img0, img1, mask0, mask1, fftshp, shp0, shp1,
                conf_mode, subpixel, normalize):
    """img0: (N,H0,W0), img1: (N,H1,W1) float32, pre-filtered.
    Returns (dx, dy, conf): center of img1 + (dx,dy) matches center of img0."""
    fy, fx = fftshp
    n = img0.shape[0]
    img0 = img0.astype(jnp.float32)
    img1 = img1.astype(jnp.float32)
    F0 = jnp.fft.rfft2(img0, s=fftshp)
    F1 = jnp.fft.rfft2(img1, s=fftshp)
    Fc = jnp.conj(F0) * F1
    C = jnp.fft.irfft2(Fc, s=fftshp)
    Cf = C.reshape(n, fy * fx)
    Nc = None
    peak_only = normalize == 'peak'
    if normalize:
        M0 = jnp.fft.rfft2(mask0, s=fftshp)
        M1 = jnp.fft.rfft2(mask1, s=fftshp)
        Nc = jnp.conj(M0) * M1
        if peak_only:
            # peak localization only: clamp at 0.5 relative overlap so
            # the envelope-bias correction is exact near the center while
            # far-field noise amplifies < 2x (a 0.1 clamp lets sidelobe
            # noise outbid weak true peaks, measured on warped pairs)
            Cn = Cf / _normalizer_from(Nc, fftshp, clip=0.5)
        else:
            Cn = Cf / _normalizer_from(Nc, fftshp)
            Cf = Cn
    else:
        Cn = Cf
    # peaks localize on the overlap-normalized surface (the triangular
    # windowing envelope biases raw peaks toward zero displacement);
    # with normalize='peak' the confidence keeps the RAW surface ratio
    # (tuned thresholds; normalization amplifies far-field noise in the
    # mirror surface and would deflate conf by ~2x)
    dx, dy, peak = _peak_and_subpixel(Cn.reshape(n, fy, fx), fftshp, subpixel,
                                      Fc=Fc, Nc=Nc)
    # recenter: displacement between image centers, wrapped to the FFT torus
    dy = dy + (shp0[0] - shp1[0]) / 2
    dx = dx + (shp0[1] - shp1[1]) / 2
    dy = dy - jnp.round(dy / fy) * fy
    dx = dx - jnp.round(dx / fx) * fx
    if conf_mode == const.FFT_CONF_NONE:
        conf = jnp.ones_like(dx)
    elif conf_mode == const.FFT_CONF_MIRROR:
        # correlation against the point-mirrored partner: a texture that
        # matches itself mirrored as well as it matches the partner is
        # periodic/degenerate -> low confidence
        Cm = jnp.abs(jnp.fft.irfft2(F0 * F1, s=fftshp)).reshape(n, fy * fx)
        if normalize and not peak_only:
            Cm = Cm / _normalizer(M0, M1, fftshp, conj0=False)
        mx_rl = Cf.max(axis=-1)
        mx_mr = Cm.max(axis=-1)
        conf = jnp.where(mx_rl > 0, 1.0 - mx_mr / jnp.where(mx_rl > 0, mx_rl, 1.0), 0.0)
        conf = jnp.clip(conf, 0.0, 1.0)
    elif conf_mode == const.FFT_CONF_STD:
        c_std = Cf.std(axis=-1)
        conf = (1.0 - jnp.exp(-Cf.max(axis=-1) / c_std)) ** (fy * fx)
        conf = jnp.clip(conf, 0.0, 1.0)
    else:
        raise ValueError(f'unknown conf mode {conf_mode}')
    return dx, dy, conf


def xcorr_fft(img0, img1, conf_mode=const.FFT_CONF_MIRROR, **kwargs):
    """Batched displacement from FFT cross-correlation.

    Args:
        img0: (N,H0,W0) or (H0,W0) array (device or host).
        img1: (N,H1,W1) or (H1,W1).
    Kwargs:
        sigma: if >0, apply masked DoG filtering first (device).
        mask0, mask1: valid-data masks, (H,W) or (N,H,W).
        normalize: divide by overlap-area correlation of the masks.
        subpixel: True = 3x3 quadratic peak refinement; int >= 2 = local
            matrix-multiply-DFT upsampling at that factor (removes the
            quadratic fit's ~0.06 px pull-to-integer bias).
        pad: zero-pad to H0+H1-1 so displacements are unambiguous.
        pow2: round FFT sizes to powers of two.
    Returns:
        (dx, dy, conf) numpy arrays of shape (N,).
    """
    sigma = kwargs.get('sigma', 0)
    mask0 = kwargs.get('mask0', None)
    mask1 = kwargs.get('mask1', None)
    normalize = kwargs.get('normalize', False)
    normalize = normalize if normalize == 'peak' else bool(normalize)
    subpixel = kwargs.get('subpixel', False)
    subpixel = int(subpixel) if not isinstance(subpixel, bool) else subpixel
    pad = kwargs.get('pad', True)
    pow2 = kwargs.get('pow2', True)
    # keep integer images in their narrow dtype across the host->device
    # transfer (4x fewer bytes); cast to f32 on device
    img0 = jnp.asarray(img0)
    img1 = jnp.asarray(img1)
    squeeze = img0.ndim == 2
    if squeeze:
        img0, img1 = img0[None], img1[None]
    if sigma > 0:
        from feabas_tpu.ops.filters import masked_dog_filter
        # normalize='peak' reserves the masks for peak normalization
        # only: feeding them to the DoG too (boundary-leakage
        # subtraction) would change the raw surfaces and the confidence
        # for border blocks, diverging from the fused path's unmasked
        # filter and the tuned conf thresholds
        dog_m0 = None if normalize == 'peak' else mask0
        dog_m1 = None if normalize == 'peak' else mask1
        img0 = masked_dog_filter(img0, sigma, mask=dog_m0)
        img1 = masked_dog_filter(img1, sigma, mask=dog_m1)
    shp0 = tuple(int(s) for s in img0.shape[-2:])
    shp1 = tuple(int(s) for s in img1.shape[-2:])
    if pad:
        fftshp = tuple(good_fft_size(s0 + s1 - 1, pow2=pow2) for s0, s1 in zip(shp0, shp1))
    else:
        fftshp = tuple(good_fft_size(max(s0, s1), pow2=pow2) for s0, s1 in zip(shp0, shp1))

    def _expand_mask(m, shp, nbatch):
        if m is None:
            return jnp.ones((1,) + shp, jnp.float32)
        m = jnp.asarray(m, dtype=jnp.float32)
        if m.ndim == 2:
            m = m[None]
        return m

    m0 = _expand_mask(mask0, shp0, img0.shape[0])
    m1 = _expand_mask(mask1, shp1, img1.shape[0])
    dx, dy, conf = _xcorr_core(img0, img1, m0, m1, fftshp, shp0, shp1,
                               int(conf_mode), subpixel, normalize)
    # ONE device->host fetch for all three outputs: each fetch pays a full
    # host<->device round trip
    stacked = jnp.stack([dx.astype(jnp.float32),
                         dy.astype(jnp.float32), conf])
    if kwargs.get('return_device', False):
        return stacked  # (3, N) device array; caller batches the fetch
    out = np.asarray(stacked)
    dx, dy, conf = out[0], out[1], out[2]
    if squeeze:
        return dx[0], dy[0], conf[0]
    return dx, dy, conf
