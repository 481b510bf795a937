"""Device-side mesh rendering: on-device triangle rasterization + affine
source-coordinate evaluation + bilinear sampling, in ONE XLA program per
output block.

This is the production device path for the render stage (reference hot
path: ``feabas/renderer.py:566-683`` + ``feabas/common.py:256``). The
design is transfer-driven: the only dense traffic a warp renderer
fundamentally needs is the source pixels up (once) and the uint8 output
down. So nothing per-pixel is uploaded at all:

- the host ships a per-block TRIANGLE COEFFICIENT TABLE (KBs): barycentric
  inside-test coefficients + the target->source affine of each candidate
  triangle, both expressed in block-local coordinates (f64 on host, f32 on
  device, so f32 roundoff scales with the block size, not the world
  extent);
- the device rasterizes by scanning the table (chunk-unrolled fori_loop,
  pure VPU elementwise math — no gathers), arbitrating overlaps by the
  same strict-greater weight rule as the native host rasterizer
  (``native/rasterize.cpp:57``), evaluates source coordinates for the
  winning triangle, quantizes them to 1/32 px (cv2 INTER_LINEAR's
  fixed-point grid) and bilinear-samples the source;
- the output fetches as uint8 (1 B/px) with rounding done on device.

Sources stay device-resident across blocks when they fit (whole-section
arrays); otherwise each block uploads only its bucket-aligned source crop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from feabas_tpu.ops.warp import (bilinear_sample,
                                 bilinear_sample_packed,
                                 pack_u8_quads)

# barycentric inside-test epsilon — same rule as native/rasterize.cpp:28
_EPS = 1e-9
# triangles per unrolled fori_loop chunk (table rows pad to a multiple)
_CHUNK = 8
# cell-binned raster: cell edge in px, and the block triangle count above
# which binning pays (below it the flat O(T) loop is already one or two
# chunks and the binned gather adds only overhead)
_CELL = 128
_CELL_MIN_TRIS = 32
# source / output block dims quantize to these multiples so a handful of
# jit signatures serve arbitrary crops
_SRC_ALIGN = 256
_OUT_ALIGN = 512
# sources at most this large stay device-resident across blocks
WHOLE_SRC_CAP = 256 * 1024 * 1024
# blocks per batched dispatch: small enough that fetching one batch's
# output overlaps the next batch's compute on the link
_GROUP_CAP = 1
# concurrent output fetches: per-transfer link latency overlaps across
# in-flight fetches
_FETCH_THREADS = 2


# 'auto' group sizing targets this many output pixels per dispatch:
# per-dispatch cost is FIXED (host table staging, program launch, one
# fetch round trip), so small blocks must batch until the group carries
# enough work to amortize it.
_GROUP_TARGET_PIXELS = 1 << 20
_GROUP_CAP_MAX = 16


def resolve_group_cap(flag=None, block_pixels=None):
    """Blocks per batched dispatch. None defers to the config knob
    (general_configs ``device.render_group_cap``); 'auto' (the default)
    consults the measured link profile: slow links want cap 1 at
    production block sizes — fetch granularity beats batched-transfer
    size because per-transfer latency overlaps across the fetch pool —
    and regardless of link, small blocks batch
    until each dispatch group covers ~``_GROUP_TARGET_PIXELS`` of output
    (``block_pixels``, when given, is the padded per-block pixel count)."""
    if flag is None:
        from feabas_tpu import config
        flag = config.render_group_cap()
    if isinstance(flag, str):
        from feabas_tpu.ops.link_probe import is_slow_link
        cap = 1 if is_slow_link() else 4
        if block_pixels:
            floor = _GROUP_TARGET_PIXELS // max(int(block_pixels), 1)
            cap = max(cap, min(floor, _GROUP_CAP_MAX))
        return max(1, cap)
    return max(1, int(flag))


def _raster_core(src, table, fillval, h, w, geodesic, out_kind,
                 n_mips=0, mip_blur=0.0):
    """Rasterize + warp one output block.

    Args:
        src: (Hs, Ws) source crop, any real dtype.
        table: (Tp, 14) f32 per-triangle rows, block-local coordinates:
            [l1x, l1y, l1c, l2x, l2y, l2c,  barycentric l1/l2 coefficients
             axx, ayx, bx,  axy, ayy, by,   target->source affine
             weight, color]                 arbitration weight, fold color
            Padding rows must have l1c < -1 (never inside) and weight=-inf.
        fillval: f32 scalar for uncovered pixels.
        h, w: static output dims.
        geodesic: static; mask pixels covered by >= 2 fold sheets.
        out_kind: static 'u8' | 'u16' | 'f32' output dtype.
        n_mips: static; additionally emit n 2x-downsampled mip levels
            (render->mip FUSION: the mip chain consumer fetches 1/4 the
            bytes per level instead of host-downsampling fetched mip0).
            Requires h, w divisible by 2**n_mips.
        mip_blur: static Gaussian sigma applied before each 2x area
            average (anti-alias, matches mipmap.mip_one_level pre_blur).
    Returns:
        flat 1-D vector of the output dtype:
        [mip0.ravel(), mip1.ravel(), ..., covered_any] — ONE array so a
        whole dispatch group fetches in a single transfer (a separate
        coverage fetch costs a full link round trip per group).
    """
    px = jnp.arange(w, dtype=jnp.float32)[None, :]
    py = jnp.arange(h, dtype=jnp.float32)[:, None]
    T = table.shape[0]
    init = (jnp.full((h, w), -jnp.inf, jnp.float32),   # winning weight
            jnp.zeros((h, w), jnp.float32),            # source x
            jnp.zeros((h, w), jnp.float32),            # source y
            jnp.zeros((h, w), jnp.int32))              # fold-sheet bitmask

    def body(ci, state):
        score, sx, sy, smask = state
        for j in range(_CHUNK):
            row = jax.lax.dynamic_slice(table, (ci * _CHUNK + j, 0),
                                        (1, 14))[0]
            l1 = row[0] * px + row[1] * py + row[2]
            l2 = row[3] * px + row[4] * py + row[5]
            inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (l1 + l2 <= 1.0 + _EPS)
            # strict > : first triangle in index order wins ties, matching
            # the native rasterizer (rasterize.cpp:57)
            take = inside & (row[12] > score)
            score = jnp.where(take, row[12], score)
            sx = jnp.where(take, row[6] * px + row[7] * py + row[8], sx)
            sy = jnp.where(take, row[9] * px + row[10] * py + row[11], sy)
            if geodesic:
                color = row[13].astype(jnp.int32)
                bit = jnp.where(color >= 0,
                                jnp.left_shift(1, jnp.maximum(color, 0)), 0)
                smask = smask | jnp.where(inside, bit, 0)
        return score, sx, sy, smask

    score, sx, sy, smask = jax.lax.fori_loop(0, T // _CHUNK, body, init)
    return _finish_raster(src, score, sx, sy, smask, fillval, geodesic,
                          out_kind, n_mips, mip_blur)


def _raster_core_cells(src, table, cand, fillval, h, w, geodesic, out_kind,
                       n_mips=0, mip_blur=0.0):
    """Cell-binned variant of ``_raster_core``: the block splits into
    ``_CELL``-px cells and each pixel tests only ITS cell's candidate
    triangles (host-binned, ascending index so the flat kernel's
    first-wins tie-break is preserved exactly). Per-pixel cost scales
    with LOCAL triangle overlap (K = padded per-cell candidate count)
    instead of the block's whole table — the montage renderer's binned
    structure (ops/montage_render.py) applied to the mesh raster loop.

    cand: (NC, K) int32 rows into ``table``; padding entries point at an
    inert row (l1c < -1, weight -inf — guaranteed by the +1 row pad in
    ``_table_for_block`` / the group pad in ``dispatch``).
    """
    C = _CELL
    ncy, ncx = h // C, w // C
    K = cand.shape[-1]
    cand = cand.reshape(ncy, ncx, K)
    loc = jnp.arange(C, dtype=jnp.float32)
    gx = ((jnp.arange(ncx, dtype=jnp.float32) * C)[None, :, None, None]
          + loc[None, None, None, :])
    gy = ((jnp.arange(ncy, dtype=jnp.float32) * C)[:, None, None, None]
          + loc[None, None, :, None])
    shape = (ncy, ncx, C, C)
    init = (jnp.full(shape, -jnp.inf, jnp.float32),
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.int32))

    def body(k, state):
        score, sx, sy, smask = state
        rows = table[cand[:, :, k]]                     # (ncy, ncx, 14)

        def r(j):
            return rows[:, :, j][:, :, None, None]

        l1 = r(0) * gx + r(1) * gy + r(2)
        l2 = r(3) * gx + r(4) * gy + r(5)
        inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (l1 + l2 <= 1.0 + _EPS)
        take = inside & (r(12) > score)
        score = jnp.where(take, r(12), score)
        sx = jnp.where(take, r(6) * gx + r(7) * gy + r(8), sx)
        sy = jnp.where(take, r(9) * gx + r(10) * gy + r(11), sy)
        if geodesic:
            color = rows[:, :, 13].astype(jnp.int32)[:, :, None, None]
            bit = jnp.where(color >= 0,
                            jnp.left_shift(1, jnp.maximum(color, 0)), 0)
            smask = smask | jnp.where(inside, bit, 0)
        return score, sx, sy, smask

    score, sx, sy, smask = jax.lax.fori_loop(0, K, body, init)

    def asm(a):
        return a.transpose(0, 2, 1, 3).reshape(h, w)

    return _finish_raster(src, asm(score), asm(sx), asm(sy), asm(smask),
                          fillval, geodesic, out_kind, n_mips, mip_blur)


def _finish_raster(src, score, sx, sy, smask, fillval, geodesic, out_kind,
                   n_mips, mip_blur):
    h, w = score.shape
    covered = score != -jnp.inf
    if geodesic:
        covered = covered & (jax.lax.population_count(smask) < 2)
    # cv2 INTER_LINEAR samples on a 1/32-px fixed-point grid; quantizing
    # keeps the device output within 1 LSB of the host path
    sxq = jnp.round(sx * 32.0) * (1.0 / 32.0)
    syq = jnp.round(sy * 32.0) * (1.0 / 32.0)
    if src.dtype == jnp.uint32:
        # uint8 source packed by pack_u8_quads: ONE gather per pixel
        out = bilinear_sample_packed(src, sxq, syq, fillval)
    elif src.dtype == jnp.uint8:
        out = bilinear_sample_packed(pack_u8_quads(src), sxq, syq, fillval)
    else:
        out = bilinear_sample(src.astype(jnp.float32), sxq, syq, fillval)
    out = jnp.where(covered, out, fillval)
    # quantize exactly as the host path writes each level to disk, so the
    # fused mip chain reads the SAME rounded values the host chain would
    def quant(x):
        if out_kind == 'u8':
            return jnp.clip(jnp.rint(x), 0, 255)
        if out_kind == 'u16':
            return jnp.clip(jnp.rint(x), 0, 65535)
        return x

    def cast(x):
        if out_kind == 'u8':
            return x.astype(jnp.uint8)
        if out_kind == 'u16':
            return x.astype(jnp.uint16)
        return x

    cur = quant(out)
    segs = [cast(cur).ravel()]
    hh, ww = h, w
    for _lvl in range(n_mips):
        if mip_blur and mip_blur > 0:
            from feabas_tpu.ops.filters import gaussian_blur
            cur = gaussian_blur(cur, float(mip_blur))
        cur = cur.reshape(hh // 2, 2, ww // 2, 2).mean(axis=(1, 3))
        cur = quant(cur)
        hh, ww = hh // 2, ww // 2
        segs.append(cast(cur).ravel())
    cov = cast(quant(jnp.where(jnp.any(covered), 1.0, 0.0)))
    segs.append(cov.reshape(1))
    return jnp.concatenate(segs)


def _flat_len(h, w, n_mips):
    """Length of the packed output vector (mips + coverage flag)."""
    n = 0
    for lvl in range(n_mips + 1):
        n += (h >> lvl) * (w >> lvl)
    return n + 1


@functools.partial(jax.jit,
                   static_argnames=('h', 'w', 'geodesic', 'out_kind',
                                    'n_mips', 'mip_blur'))
def _raster_render_shared(src, tables, fillval, h, w, geodesic, out_kind,
                          n_mips=0, mip_blur=0.0):
    """Batch of blocks against ONE shared (device-resident) source:
    one dispatch, one (B, L) fetch."""
    return jax.vmap(
        lambda t: _raster_core(src, t, fillval, h, w, geodesic, out_kind,
                               n_mips, mip_blur)
    )(tables)


@functools.partial(jax.jit,
                   static_argnames=('h', 'w', 'geodesic', 'out_kind',
                                    'n_mips', 'mip_blur'))
def _raster_render_multi(srcs, tables, fillval, h, w, geodesic, out_kind,
                         n_mips=0, mip_blur=0.0):
    """Batch of blocks each with its own (stacked, equal-shape) source
    crop: the whole wave uploads as one (B, Hs, Ws) array."""
    return jax.vmap(
        lambda s, t: _raster_core(s, t, fillval, h, w, geodesic, out_kind,
                                  n_mips, mip_blur)
    )(srcs, tables)


@functools.partial(jax.jit,
                   static_argnames=('h', 'w', 'geodesic', 'out_kind',
                                    'n_mips', 'mip_blur'))
def _raster_render_shared_cells(src, tables, cands, fillval, h, w,
                                geodesic, out_kind, n_mips=0, mip_blur=0.0):
    """Cell-binned batch against ONE shared (device-resident) source."""
    return jax.vmap(
        lambda t, c: _raster_core_cells(src, t, c, fillval, h, w, geodesic,
                                        out_kind, n_mips, mip_blur)
    )(tables, cands)


@functools.partial(jax.jit,
                   static_argnames=('h', 'w', 'geodesic', 'out_kind',
                                    'n_mips', 'mip_blur'))
def _raster_render_multi_cells(srcs, tables, cands, fillval, h, w,
                               geodesic, out_kind, n_mips=0, mip_blur=0.0):
    """Cell-binned batch, per-block (stacked, equal-shape) source crops."""
    return jax.vmap(
        lambda s, t, c: _raster_core_cells(s, t, c, fillval, h, w, geodesic,
                                           out_kind, n_mips, mip_blur)
    )(srcs, tables, cands)


def _align_up(n, align, lo):
    return max(int(lo), int(-(-int(n) // align) * align))


def _out_kind(dtype):
    dt = np.dtype(dtype)
    if dt == np.uint8:
        return 'u8'
    if dt == np.uint16:
        return 'u16'
    if dt.kind == 'f':
        return 'f32'
    return None


class DeviceRenderEngine:
    """Per-mesh device render engine (built lazily by ``MeshRenderer``).

    Holds f64 global-frame per-triangle data; ``render_blocks`` selects
    each block's candidate triangles, builds the block-local f32
    coefficient table, dispatches every block's program, THEN fetches —
    so uploads/compute/downloads of different blocks pipeline through the
    link instead of serializing per block.
    """

    def __init__(self, mesh, target_gear, source_gear, tri_weights,
                 colors=None):
        vw = np.asarray(mesh.vertices_w_offset(target_gear), np.float64)
        tris = mesh.triangles
        self._P = vw[tris]                                # (T, 3, 2) target
        vs = np.asarray(mesh.vertices_w_offset(source_gear), np.float64)
        self._Psrc = vs[tris]                             # (T, 3, 2) source
        self._tb = np.concatenate(
            [self._P.min(axis=1), self._P.max(axis=1)], axis=1)  # x0 y0 x1 y1
        A, b = mesh.triangle_affine_tform(gear0=target_gear,
                                          gear1=source_gear)
        self._A = np.asarray(A, np.float64)
        self._b = np.asarray(b, np.float64)
        a = self._P[:, 0]
        e1 = self._P[:, 1] - a
        e2 = self._P[:, 2] - a
        den = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        ok = np.abs(den) > 1e-12
        safe = np.where(ok, den, 1.0)
        # l1/l2 as affine functions of world position (c_x, c_y, c_0)
        self._l1 = np.stack([e2[:, 1] / safe, -e2[:, 0] / safe], -1)
        self._l2 = np.stack([-e1[:, 1] / safe, e1[:, 0] / safe], -1)
        self._l1c = -(a * self._l1).sum(-1)
        self._l2c = -(a * self._l2).sum(-1)
        w = np.asarray(tri_weights, np.float64).copy()
        w[~ok] = -np.inf                                  # degenerate: never
        self._w = w
        self._colors = (np.full(len(tris), -1, np.float64) if colors is None
                        else np.asarray(colors, np.float64))
        self._geodesic = colors is not None
        self._whole_src = None       # (jnp array, (x0, y0)) when resident
        self._whole_src_failed = False

    def _table_for_block(self, sel, origin, src_origin, wts):
        """(Tp, 14) f32 block-local coefficient table for triangles sel."""
        ox, oy = origin
        sx0, sy0 = src_origin
        n = sel.size
        # +1: at least one inert row always exists past the real rows, so
        # cell candidate tables can use index n (or any later row) as the
        # padding sentinel
        Tp = _align_up(n + 1, _CHUNK, _CHUNK)
        tab = np.zeros((Tp, 14), np.float32)
        tab[:, 2] = -2.0               # padding rows: l1 < 0 -> never inside
        tab[:, 12] = -np.inf
        tab[:, 13] = -1.0
        if n:
            l1 = self._l1[sel]
            l2 = self._l2[sel]
            A = self._A[sel]
            b = self._b[sel]
            tab[:n, 0:2] = l1
            tab[:n, 2] = self._l1c[sel] + l1[:, 0] * ox + l1[:, 1] * oy
            tab[:n, 3:5] = l2
            tab[:n, 5] = self._l2c[sel] + l2[:, 0] * ox + l2[:, 1] * oy
            tab[:n, 6] = A[:, 0, 0]
            tab[:n, 7] = A[:, 1, 0]
            tab[:n, 8] = b[:, 0] + ox * A[:, 0, 0] + oy * A[:, 1, 0] - sx0
            tab[:n, 9] = A[:, 0, 1]
            tab[:n, 10] = A[:, 1, 1]
            tab[:n, 11] = b[:, 1] + ox * A[:, 0, 1] + oy * A[:, 1, 1] - sy0
            tab[:n, 12] = wts[sel]
            tab[:n, 13] = self._colors[sel]
        return tab

    def _cells_for_block(self, sel, origin, hp, wp):
        """(NC, Kp) int32 cell-candidate table for the cell-binned raster
        kernel: triangles (as LOCAL row indices into this block's
        coefficient table) binned to the ``_CELL``-px cells their bboxes
        touch, ascending within each cell so the flat kernel's
        first-in-index tie-break is preserved; padding entries point at
        row ``sel.size`` (inert by the +1 pad in ``_table_for_block``)."""
        C = _CELL
        ncy, ncx = hp // C, wp // C
        NC = ncy * ncx
        n = sel.size
        ox, oy = origin
        tb = self._tb[sel]
        bx0 = np.clip(np.floor((tb[:, 0] - ox) / C).astype(np.int64),
                      0, ncx - 1)
        by0 = np.clip(np.floor((tb[:, 1] - oy) / C).astype(np.int64),
                      0, ncy - 1)
        bx1 = np.clip(np.floor((tb[:, 2] - ox) / C).astype(np.int64),
                      0, ncx - 1)
        by1 = np.clip(np.floor((tb[:, 3] - oy) / C).astype(np.int64),
                      0, ncy - 1)
        spanx = bx1 - bx0 + 1
        spany = by1 - by0 + 1
        cells = []
        tris = []
        all_tri = np.arange(n, dtype=np.int64)
        for dy in range(int(spany.max())):
            my = dy < spany
            for dx in range(int(spanx.max())):
                m = my & (dx < spanx)
                if not m.any():
                    continue
                cells.append((by0[m] + dy) * ncx + (bx0[m] + dx))
                tris.append(all_tri[m])
        cell_ids = np.concatenate(cells)
        tri_ids = np.concatenate(tris)
        order = np.lexsort((tri_ids, cell_ids))
        cell_sorted = cell_ids[order]
        starts = np.searchsorted(cell_sorted, np.arange(NC))
        pos = np.arange(len(order)) - starts[cell_sorted]
        K = int(pos.max()) + 1
        Kp = max(4, 1 << (K - 1).bit_length())
        cand = np.full((NC, Kp), n, np.int32)
        cand[cell_sorted, pos] = tri_ids[order]
        return cand

    def _table_affine(self, A, b, origin, src_origin):
        """Single-row table: one always-inside 'triangle' carrying an
        affine that covers the whole block (the renderer's affine
        short-circuit, reference renderer.py:94-109,453-510) — the raster
        loop cost drops to one chunk regardless of mesh density."""
        ox, oy = origin
        sx0, sy0 = src_origin
        tab = np.zeros((_CHUNK, 14), np.float32)
        tab[:, 2] = -2.0
        tab[:, 12] = -np.inf
        tab[:, 13] = -1.0
        # l1 = l2 = 0.25 everywhere: inside for every pixel
        tab[0, 0:6] = [0.0, 0.0, 0.25, 0.0, 0.0, 0.25]
        tab[0, 6] = A[0, 0]
        tab[0, 7] = A[1, 0]
        tab[0, 8] = b[0] + ox * A[0, 0] + oy * A[1, 0] - sx0
        tab[0, 9] = A[0, 1]
        tab[0, 10] = A[1, 1]
        tab[0, 11] = b[1] + ox * A[0, 1] + oy * A[1, 1] - sy0
        tab[0, 12] = 1.0
        return tab

    def source_can_reside(self, loader):
        """Cheap predicate mirroring ``_resident_source``'s gate (no
        upload): can this loader's whole source live device-resident, so
        per-block work ships only the tiny coefficient table?"""
        img = getattr(loader, '_img', None)
        if img is None or not hasattr(loader, 'bbox') or img.ndim != 2:
            return False
        itemsize = np.dtype(getattr(loader, 'dtype', None)
                            or img.dtype).itemsize
        return img.size * itemsize <= WHOLE_SRC_CAP

    def _resident_source(self, loader, fillval):
        """Upload a small whole-section source ONCE and reuse it for every
        block (saves the dominant per-block uplink when the source fits)."""
        if self._whole_src is not None:
            return self._whole_src
        if self._whole_src_failed:
            return None
        img = getattr(loader, '_img', None)
        itemsize = np.dtype(getattr(loader, 'dtype', None)
                            or (img.dtype if img is not None else np.uint8)
                            ).itemsize
        if (img is None or not hasattr(loader, 'bbox') or img.ndim != 2
                or img.size * itemsize > WHOLE_SRC_CAP):
            self._whole_src_failed = True
            return None
        x0, y0 = loader.bbox[:2]
        # pad 2 px of fillval all around (matches the host path's
        # BORDER_CONSTANT blend at the image edge), then bucket-align
        pad = 2
        H = _align_up(img.shape[0] + 2 * pad, _SRC_ALIGN, _SRC_ALIGN)
        W = _align_up(img.shape[1] + 2 * pad, _SRC_ALIGN, _SRC_ALIGN)
        data = loader.preprocess(img) if hasattr(loader, 'preprocess') else img
        # canvas dtype follows the loader's declared dtype (the host path
        # pastes preprocessed data into a loader.dtype canvas), NOT the raw
        # image dtype: preprocess may change dtype/range (inverse, CLAHE,
        # float normalization)
        dt = np.dtype(getattr(loader, 'dtype', None) or data.dtype)
        buf = np.full((H, W), fillval, dt)
        buf[pad:pad + img.shape[0], pad:pad + img.shape[1]] = data
        dev = jax.device_put(buf)
        if buf.dtype == np.uint8:
            # pack the bilinear quads on device: upload stays 1 B/px, the
            # per-pixel sampling gather drops from 4 reads to 1
            dev = pack_u8_quads(dev)
        self._whole_src = (dev, (x0 - pad, y0 - pad))
        return self._whole_src

    def render_blocks(self, blocks, loader, fillval, out_dtype,
                      wts=None, shortcircuit=None, emit_mips=0,
                      mip_blur=0.0, claim=None, group_cap=None,
                      **crop_kwargs):
        """Render output blocks [(x0, y0, x1, y1)] through the mesh.

        Returns [(array | None)] aligned with ``blocks``; None when the
        block has no mesh coverage. Groups dispatch as they fill and
        fetch on a small thread pool, so host prep, device compute, and
        both transfer legs of different blocks overlap through the link.

        With ``emit_mips`` = k, each covered result is a TUPLE
        (mip0, mip1, ..., mipk) computed in-program (render->mip fusion:
        the downlink grows 1/4 per level instead of the host re-reading
        and downsampling mip0). Blocks whose dims don't divide 2**k (or
        that pad) fall back to mip0-only for that block and the host
        finishes the chain. ``claim`` (callable -> block index or None)
        replaces in-order iteration — the hybrid host+device scheduler
        feeds both lanes from one work queue. ``group_cap`` overrides
        blocks-per-dispatch (None -> config/link-probe auto).
        """
        out_kind = _out_kind(out_dtype)
        if wts is None:
            wts = self._w
        if group_cap is None:
            # keep the raw flag ('auto' or int): 'auto' resolves PER
            # GROUP KEY in the prep loop so the cap can scale with the
            # group's block size (small blocks amortize dispatch cost)
            from feabas_tpu import config
            group_cap = config.render_group_cap()
        resident = None
        from feabas_tpu.dal import StreamLoader
        if isinstance(loader, StreamLoader):
            resident = self._resident_source(loader, fillval)
        # Blocks sharing output dims + source shape batch into a single
        # program (vmap): the wave's tables upload as one array, its
        # source crops as one stacked array, the outputs fetch as ONE
        # (B, L) packed vector (mips + coverage flag — a separate
        # coverage fetch would pay a full link round trip per group).
        # Groups dispatch AS SOON AS they fill (host prep of later
        # blocks overlaps device compute of earlier ones) and fetch on a
        # 2-thread pool (per-transfer link latency of one fetch overlaps
        # the wire time of another).
        prepared = {}     # block index -> (h, w, group_key, tab, src, nm)
        results = [None] * len(blocks)
        fv = jnp.float32(fillval)
        pending = {}               # group_key -> [block index]
        fetches = []               # (idxs, future -> flat (B, L))
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=_FETCH_THREADS)

        def dispatch(key, idxs):
            hp, wp, nm = key[0], key[1], key[2]
            Tp = max(t.shape[0] for t in
                     (prepared[i][3] for i in idxs))
            Tp = _align_up(1 << int(Tp - 1).bit_length(), _CHUNK, _CHUNK)
            tabs = np.full((len(idxs), Tp, 14), 0.0, np.float32)
            tabs[:, :, 2] = -2.0
            tabs[:, :, 12] = -np.inf
            tabs[:, :, 13] = -1.0
            for k, i in enumerate(idxs):
                t = prepared[i][3]
                tabs[k, :t.shape[0]] = t
            cands = None
            if key[-1] == 'cells':
                # group K = max of the blocks' (pow2) K; padding entries
                # point at row Tp-1, inert for EVERY block (each block's
                # own rows end with >=1 inert row by the +1 table pad and
                # the group pad above fills the rest)
                Kp = max(prepared[i][5].shape[-1] for i in idxs)
                NC = prepared[idxs[0]][5].shape[0]
                cands = np.full((len(idxs), NC, Kp), Tp - 1, np.int32)
                for k, i in enumerate(idxs):
                    c = prepared[i][5]
                    cands[k, :, :c.shape[-1]] = c
            if key[3] == 'resident':
                if cands is None:
                    out_dev = _raster_render_shared(
                        resident[0], jax.device_put(tabs), fv, hp, wp,
                        self._geodesic, out_kind, nm, mip_blur)
                else:
                    out_dev = _raster_render_shared_cells(
                        resident[0], jax.device_put(tabs),
                        jax.device_put(cands), fv, hp, wp,
                        self._geodesic, out_kind, nm, mip_blur)
            else:
                srcs = np.stack([prepared[i][4] for i in idxs])
                if cands is None:
                    out_dev = _raster_render_multi(
                        jax.device_put(srcs), jax.device_put(tabs), fv,
                        hp, wp, self._geodesic, out_kind, nm, mip_blur)
                else:
                    out_dev = _raster_render_multi_cells(
                        jax.device_put(srcs), jax.device_put(tabs),
                        jax.device_put(cands), fv, hp, wp,
                        self._geodesic, out_kind, nm, mip_blur)
            fetches.append((idxs, key, pool.submit(np.asarray, out_dev)))

        def consume(entry):
            idxs, key, fut = entry
            flat = fut.result()
            hp, wp, nm = key[0], key[1], key[2]
            for k, i in enumerate(idxs):
                if flat[k, -1] == 0:          # coverage flag
                    continue
                h, w = prepared[i][0], prepared[i][1]
                mips = []
                off = 0
                for lvl in range(nm + 1):
                    hl, wl = hp >> lvl, wp >> lvl
                    blk = flat[k, off:off + hl * wl].reshape(hl, wl)
                    blk = blk[:h >> lvl, :w >> lvl]
                    if (out_kind == 'f32'
                            and np.dtype(out_dtype) != np.float32):
                        blk = blk.astype(out_dtype)
                    mips.append(blk)
                    off += hl * wl
                results[i] = tuple(mips) if emit_mips else mips[0]

        # Hybrid backpressure: with an external work queue, claiming a
        # block REMOVES it from the host lane — so the device lane must
        # only hold as much work as its pipeline can keep in flight
        # (uplink + compute + downlink), or it grabs the whole queue at
        # host-prep speed and the hybrid degenerates to pure-device.
        # Blocking on the oldest fetch before each new claim paces claims
        # to the device's actual completion rate.
        pace = None
        if claim is not None:
            max_inflight = _FETCH_THREADS + 1

            def pace():
                while len(fetches) >= max_inflight:
                    consume(fetches.pop(0))

        try:
            self._render_prepare_dispatch(
                blocks, loader, fillval, out_kind, wts, shortcircuit,
                resident, prepared, pending, dispatch, crop_kwargs,
                emit_mips, group_cap, claim, pace=pace)
            for key, idxs in pending.items():
                dispatch(key, idxs)
            # ---- drain remaining fetches (in dispatch order) ---------
            for entry in fetches:
                consume(entry)
        finally:
            pool.shutdown(wait=True)
        return results

    def _render_prepare_dispatch(self, blocks, loader, fillval, out_kind,
                                 wts, shortcircuit, resident, prepared,
                                 pending, dispatch, crop_kwargs,
                                 emit_mips=0, group_cap=_GROUP_CAP,
                                 claim=None, pace=None):
        """Host prep: per-block candidate selection, coefficient table,
        source crop; groups dispatch as soon as they fill. ``pace`` (from
        the hybrid scheduler) blocks until the device pipeline has room
        before the next claim."""
        if claim is None:
            order = iter(range(len(blocks)))

            def claim():
                return next(order, None)

        caps = {}

        def cap_for(key):
            c = caps.get(key)
            if c is None:
                c = resolve_group_cap(group_cap,
                                      block_pixels=key[0] * key[1])
                caps[key] = c
            return c

        while True:
            if pace is not None:
                pace()
            i = claim()
            if i is None:
                break
            bbox = blocks[i]
            x0 = int(np.floor(bbox[0]))
            y0 = int(np.floor(bbox[1]))
            x1 = int(np.ceil(bbox[2]))
            y1 = int(np.ceil(bbox[3]))
            h, w = y1 - y0, x1 - x0
            if h <= 0 or w <= 0:
                continue
            sc = shortcircuit((x0, y0, x1, y1)) if shortcircuit else None
            if sc is None:
                tb = self._tb
                sel = np.nonzero((tb[:, 0] < x1) & (tb[:, 2] > x0) &
                                 (tb[:, 1] < y1) & (tb[:, 3] > y0) &
                                 np.isfinite(wts))[0]
                if sel.size == 0:
                    continue
            hp = _align_up(h, _OUT_ALIGN, min(_OUT_ALIGN, 64))
            wp = _align_up(w, _OUT_ALIGN, min(_OUT_ALIGN, 64))
            # fused mips only for unpadded, 2**k-divisible blocks (padding
            # would let the mip pre-blur bleed fill into the real region;
            # odd dims can't match the host INTER_AREA chain exactly)
            nm = emit_mips if (emit_mips and hp == h and wp == w
                               and h % (1 << emit_mips) == 0
                               and w % (1 << emit_mips) == 0) else 0
            if resident is not None:
                src_origin = resident[1]
                src = None
                key = (hp, wp, nm, 'resident')
            else:
                if sc is not None:
                    # source extent = affine image of the block corners
                    A, b = sc
                    cn = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]],
                                  np.float64)
                    ps = cn @ np.asarray(A) + np.asarray(b)
                else:
                    ps = self._Psrc[sel].reshape(-1, 2)
                sx0 = int(np.floor(ps[:, 0].min())) - 2
                sy0 = int(np.floor(ps[:, 1].min())) - 2
                sx1 = int(np.ceil(ps[:, 0].max())) + 2
                sy1 = int(np.ceil(ps[:, 1].max())) + 2
                sw = _align_up(sx1 - sx0, _SRC_ALIGN, _SRC_ALIGN)
                sh = _align_up(sy1 - sy0, _SRC_ALIGN, _SRC_ALIGN)
                src = loader.crop((sx0, sy0, sx0 + sw, sy0 + sh),
                                  return_empty=True, **crop_kwargs)
                if src is None:
                    src = np.full((_SRC_ALIGN, _SRC_ALIGN), fillval,
                                  np.uint8 if out_kind == 'u8' else
                                  np.float32)
                src = np.ascontiguousarray(src)
                key = (hp, wp, nm, src.shape, src.dtype.name)
                src_origin = (sx0, sy0)
            cand = None
            if sc is not None:
                tab = self._table_affine(sc[0], sc[1], (x0, y0), src_origin)
            else:
                tab = self._table_for_block(sel, (x0, y0), src_origin, wts)
                if sel.size > _CELL_MIN_TRIS:
                    cand = self._cells_for_block(sel, (x0, y0), hp, wp)
            key = key + (('cells',) if cand is not None else ('flat',))
            prepared[i] = (h, w, key, tab, src, cand)
            grp = pending.setdefault(key, [])
            grp.append(i)
            if len(grp) >= cap_for(key):
                dispatch(key, pending.pop(key))
