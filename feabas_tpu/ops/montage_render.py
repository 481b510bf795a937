"""Device-side montage blending: all hit tiles of an output block
rasterized, sampled, and blended (LINEAR, or two-band PYRAMID — the
production default blend) in ONE XLA program.

The stitch render stage (reference hot path ``stitcher.py:1399-1556``)
composes thousands of small warped tiles per section; the host path
pays per-tile Python/numpy overhead (crop_field + remap + weight maps
per tile), which dominates at MultiSEM tile counts (~0.6 MB/s on 10k
128-px tiles). Here the host ships per-tile triangle coefficient
tables (the ``DeviceRenderEngine`` 14-column format, block-local) plus
the stacked tile images, and the device does everything:

- the output block decomposes into fixed CELLS (static shape); each
  cell carries a padded candidate list of the tiles whose bounds touch
  it (host-built, tiny int32 table) — the classic binned rasterizer,
  so per-pixel work scales with LOCAL overlap (2-4 tiles), not the
  block's total tile count;
- per candidate: rasterize its table rows on the cell grid, evaluate
  tile-local source coordinates, one packed-quad bilinear gather per
  pixel, per-tile gain/offset transfer, and the same
  distance-to-tile-border blend weight as the host
  (``min(sx, tw-sx, sy, th-sy) / margin`` clipped to [0, 1]);
- accumulate sum(w*val) / sum(w), fill uncovered pixels in-program,
  fetch uint8. PYRAMID adds a low-band accumulator fed by a
  once-per-section blurred copy of the tile stack (``pack_low_stack``)
  plus the dominant tile's high band — same two-band rule as the host.

Traffic per block: tile images up (~coverage x output bytes, uint8) +
uint8 output down — the same anatomy that makes the section renderer
link-bound instead of host-bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from feabas_tpu.ops.warp import pack_u8_quads, bilinear_sample_packed

# cell edge (px): smaller cells tighten the per-cell candidate count K
# (per-pixel cost scales with K, the dominant term)
CELL = 64
# candidate-list cap: blocks where one cell touches more tiles fall
# back to the host path (pathological overlap)
K_CAP = 64
# whole-section tile stacks up to this many PACKED bytes stay
# device-resident across blocks (uploaded once; a 10k-tile MultiSEM
# section is ~655 MB packed — well inside one chip's HBM)
RESIDENT_STACK_CAP = 4 * 1024 ** 3
# build the resident stack only past this tile count (below it the
# per-block stacks are cheap anyway)
RESIDENT_STACK_MIN_TILES = 64
# table rows unroll in chunks of this
_R_CHUNK = 8


@functools.partial(jax.jit,
                   static_argnames=('ncy', 'ncx', 'out_kind', 'pyramid'))
def montage_blend(srcs, lows, gmap, tables, aux, cands, fillval, ncy, ncx,
                  out_kind='u8', pyramid=False):
    """Blend one output block from per-tile tables + sources.

    Args:
        srcs: (N, Hs, Ws) uint32 packed-quad tile images (pack_u8_quads)
            — either the block's hit tiles or a DEVICE-RESIDENT
            whole-section stack (uploaded once, reused every block).
        lows: (N, Hs, Ws) uint32 packed-quad MASK-NORMALIZED-BLURRED tile
            images (``pack_low_stack``), the PYRAMID low band; pass
            ``srcs`` when pyramid=False (unused).
        gmap: (T,) int32 mapping the block-local tile slot to its row in
            ``srcs`` (identity when srcs holds just this block's tiles).
        tables: (T, R, 14) f32 per-tile triangle tables, block-local
            coordinates, source = TILE-LOCAL pixels (padding rows have
            l1c < -1 and weight=-inf; padding TILES are all padding rows).
        aux: (T, 5) f32 per tile: [tw, th, margin, gain, offset]
            (tw/th = true tile extent for border-distance weights).
        cands: (C, K) int32 tile indices per cell, -1 padded;
            C == ncy * ncx.
        fillval: f32 scalar for uncovered pixels.
        ncy, ncx: static cell grid dims (output is (ncy*CELL, ncx*CELL)).
        out_kind: 'u8' | 'f32'.
        pyramid: static; two-band blend — low frequencies mix linearly,
            high frequencies come from the dominant tile (host path:
            stitcher.py crop PYRAMID branch; reference stitcher.py:1484).
            The blur lives in TILE frame (computed once per section on
            the resident stack); Gaussian blur commutes with the
            near-rigid tile warps, so this matches the host's
            block-frame blur to sub-LSB.
    Returns:
        (out (H, W), covered_any bool scalar)
    """
    R = tables.shape[1]
    K = cands.shape[1]

    def per_cell(cidx, cand_row):
        cy = (cidx // ncx) * CELL
        cx = (cidx % ncx) * CELL
        px = cx.astype(jnp.float32) + \
            jnp.arange(CELL, dtype=jnp.float32)[None, :]
        py = cy.astype(jnp.float32) + \
            jnp.arange(CELL, dtype=jnp.float32)[:, None]

        def body(k, state):
            if pyramid:
                acc, wacc, best_w, best_hi = state
            else:
                acc, wacc = state
            idx = cand_row[k]
            live = idx >= 0
            i = jnp.maximum(idx, 0)
            tab = tables[i]                       # (R, 14)
            a = aux[i]                            # (5,)
            src = srcs[gmap[i]]                   # (Hs, Ws)
            score = jnp.full((CELL, CELL), -jnp.inf, jnp.float32)
            sx = jnp.zeros((CELL, CELL), jnp.float32)
            sy = jnp.zeros((CELL, CELL), jnp.float32)
            for j in range(R):                    # R is small (tile mesh)
                row = tab[j]
                l1 = row[0] * px + row[1] * py + row[2]
                l2 = row[3] * px + row[4] * py + row[5]
                inside = (l1 >= -1e-9) & (l2 >= -1e-9) \
                    & (l1 + l2 <= 1.0 + 1e-9)
                take = inside & (row[12] > score)
                score = jnp.where(take, row[12], score)
                sx = jnp.where(take, row[6] * px + row[7] * py + row[8], sx)
                sy = jnp.where(take, row[9] * px + row[10] * py + row[11],
                               sy)
            covered = (score != -jnp.inf) & live
            # cv2 INTER_LINEAR's 1/32-px fixed-point grid (host parity)
            sxq = jnp.round(sx * 32.0) * (1.0 / 32.0)
            syq = jnp.round(sy * 32.0) * (1.0 / 32.0)
            val = bilinear_sample_packed(src, sxq, syq, 0.0)
            val = val * a[3] + a[4]
            # blend weight: distance to the source-tile border, in
            # tile-local pixels (host: min(map_x, tw-map_x, ...)/margin)
            d = jnp.minimum(jnp.minimum(sx, a[0] - sx),
                            jnp.minimum(sy, a[1] - sy))
            w = jnp.clip(d / a[2], 0.0, 1.0)
            w = jnp.where(covered, w, 0.0)
            if pyramid:
                lowv = bilinear_sample_packed(lows[gmap[i]], sxq, syq, 0.0)
                # blur is linear, so the gain/offset transfer commutes:
                # host blurs the transferred image, this transfers the
                # blurred one — identical
                lowv = lowv * a[3] + a[4]
                # strict > with best_w starting at 0: first tile in hits
                # order wins ties AND zero-weight border pixels never
                # become the dominant tile (host: m & (w > best_w))
                upd = w > best_w
                best_w = jnp.where(upd, w, best_w)
                best_hi = jnp.where(upd, val - lowv, best_hi)
                return acc + lowv * w, wacc + w, best_w, best_hi
            return acc + val * w, wacc + w

        zero = jnp.zeros((CELL, CELL), jnp.float32)
        if pyramid:
            acc, wacc, _, best_hi = jax.lax.fori_loop(
                0, K, body, (zero, zero, zero, zero))
        else:
            acc, wacc = jax.lax.fori_loop(0, K, body, (zero, zero))
            best_hi = 0.0
        out = acc / jnp.maximum(wacc, 1e-20) + best_hi
        out = jnp.where(wacc > 0, out, fillval)
        return out, jnp.any(wacc > 0)

    C = ncy * ncx
    outs, covs = jax.vmap(per_cell)(jnp.arange(C, dtype=jnp.int32), cands)
    out = outs.reshape(ncy, ncx, CELL, CELL).transpose(0, 2, 1, 3) \
        .reshape(ncy * CELL, ncx * CELL)
    if out_kind == 'u8':
        out = jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)
    return out, jnp.any(covs)


@jax.jit
def pack_tile_stack(srcs_u8):
    """(T, Hs, Ws) uint8 -> packed-quad uint32 on device (upload stays
    1 B/px; sampling costs one gather per pixel)."""
    return jax.vmap(pack_u8_quads)(srcs_u8)


@functools.partial(jax.jit, static_argnames=('sigma', 'chunk'))
def pack_low_stack(packed, twth, sigma, chunk=256):
    """PYRAMID low band: mask-normalized per-tile Gaussian blur of a
    PACKED tile stack -> packed low-band stack, one dispatch.

    Byte 0 of a ``pack_u8_quads`` word is the original pixel, so the
    source plane recovers with one AND — the low stack derives from the
    already-resident packed stack with no extra upload. The blur runs in
    TILE frame with the tile's valid rectangle as the mask (host blurs
    the warped tile in BLOCK frame: stitcher.py crop PYRAMID branch);
    isotropic Gaussian blur commutes with the near-rigid stitching warps,
    so the two agree to sub-LSB. The low band quantizes to uint8: its
    error enters ``low_blend + (val - low_best)`` twice with opposite
    sign at the dominant tile, so the net output error stays ~1 LSB.
    ``lax.map`` processes ``chunk`` tiles at a time so the f32 transient
    never holds the whole stack (10k MultiSEM tiles would be ~2.6 GB)."""
    from feabas_tpu.ops.filters import gaussian_blur
    N, H, W = packed.shape

    def one(pk, a):
        img = (pk & jnp.uint32(0xff)).astype(jnp.float32)
        x = jnp.arange(W, dtype=jnp.float32)[None, :]
        y = jnp.arange(H, dtype=jnp.float32)[:, None]
        # host inclusion is 0 < sx < tw (w > 0): integer grid [1, tw-1]
        m = ((x > 0.5) & (x < a[0] - 0.5) &
             (y > 0.5) & (y < a[1] - 0.5)).astype(jnp.float32)
        num = gaussian_blur(img * m, sigma)
        den = gaussian_blur(m, sigma)
        low = jnp.where(den > 1e-6, num / jnp.clip(den, 1e-6, None), img)
        return pack_u8_quads(jnp.clip(jnp.rint(low), 0, 255)
                             .astype(jnp.uint8))

    pad = (-N) % chunk
    pk = jnp.pad(packed, ((0, pad), (0, 0), (0, 0)))
    tw = jnp.pad(twth, ((0, pad), (0, 0)), constant_values=1.0)
    out = jax.lax.map(
        lambda args: jax.vmap(one)(*args),
        (pk.reshape(-1, chunk, H, W), tw.reshape(-1, chunk, 2)))
    return out.reshape(-1, H, W)[:N]


def _pow2(n, lo=1):
    return max(lo, 1 << int(max(n - 1, 0)).bit_length())


class MontageDeviceEngine:
    """Per-section device montage blender (built lazily by
    ``MontageRenderer``). Caches per-tile ``DeviceRenderEngine`` tables
    and device-resident packed tile images across blocks."""

    def __init__(self, renderer):
        self._mr = renderer
        self._engines = {}
        self._tile_dev = {}          # fileid -> host uint8 tile buffer
        self._tile_shape = None      # common padded (th, tw)
        self._stack = None           # device-resident packed (N,hp,wp)
        self._stack_low = None       # its PYRAMID low band (lazy)
        self._stack_failed = False

    def _engine(self, t):
        eng = self._engines.get(t)
        if eng is None:
            from feabas_tpu.ops.render import DeviceRenderEngine
            from feabas_tpu import constant as const
            mesh = self._mr.meshes[t]
            eng = DeviceRenderEngine(
                mesh, const.MESH_GEAR_MOVING, const.MESH_GEAR_INITIAL,
                tri_weights=np.ones(len(mesh.triangles)))
            self._engines[t] = eng
        return eng

    def _tile_source(self, t, fillval):
        dev = self._tile_dev.get(t)
        if dev is not None:
            return dev
        from feabas_tpu.dal import TileView
        tw, th = self._mr._tile_sizes[t]
        tw, th = int(round(tw)), int(round(th))
        hp, wp = self._ensure_tile_shape()
        img = TileView(self._mr.loader, t).crop((0, 0, tw, th))
        buf = np.full((hp, wp), fillval, np.uint8)
        if img is not None:
            im = np.asarray(img)
            if im.dtype != np.uint8:
                im = np.clip(np.rint(im), 0, 255).astype(np.uint8)
            buf[:im.shape[0], :im.shape[1]] = im[:hp, :wp]
        dev = buf
        self._tile_dev[t] = dev
        return dev

    def _ensure_tile_shape(self):
        if self._tile_shape is None:
            mx = self._mr._tile_sizes.max(axis=0)
            self._tile_shape = (_pow2(int(round(mx[1])), 8),
                                _pow2(int(round(mx[0])), 8))
        return self._tile_shape

    def _resident_stack(self, fillval):
        """Upload the WHOLE section's tile images once (packed on
        device); every subsequent block then ships only its tables and
        fetches only its uint8 output — the same resident-source design
        as the section renderer (ops/render.py _resident_source)."""
        if self._stack is not None:
            return self._stack
        if self._stack_failed:
            return None
        N = len(self._mr.meshes)
        hp, wp = self._ensure_tile_shape()
        if (N < RESIDENT_STACK_MIN_TILES
                or N * hp * wp * 4 > RESIDENT_STACK_CAP):
            self._stack_failed = True
            return None
        buf = np.full((N, hp, wp), fillval, np.uint8)
        for t in range(N):
            buf[t] = self._tile_source(t, fillval)
        self._stack = pack_tile_stack(jax.device_put(buf))
        self._tile_dev.clear()       # host copies no longer needed
        return self._stack

    def supported(self, blend):
        mr = self._mr
        return (blend in ('LINEAR', 'PYRAMID') and not mr._maskouts
                and getattr(mr.loader, 'number_of_channels', 1) in (None, 1)
                and np.dtype(mr.loader.dtype) == np.uint8)

    def _resident_low(self):
        """Low-band stack for the resident packed stack (computed once on
        device from the resident stack itself — no extra upload)."""
        if self._stack_low is None and self._stack is not None:
            twth = np.asarray(self._mr._tile_sizes, np.float32)
            self._stack_low = pack_low_stack(
                self._stack, jax.device_put(twth),
                float(self._mr._pyramid_sigma))
        return self._stack_low

    def _dispatch_block(self, bbox, hits, fillval, blend='LINEAR'):
        """Host prep + async dispatch of one block.

        Returns None (no coverage), NotImplemented (host path needed),
        or (out_dev, cov_dev, H, W) device futures."""
        mr = self._mr
        pyramid = (blend == 'PYRAMID')
        xbase = int(np.floor(bbox[0]))
        ybase = int(np.floor(bbox[1]))
        H = int(np.ceil(bbox[3])) - ybase
        W = int(np.ceil(bbox[2])) - xbase
        ncy = -(-H // CELL)
        ncx = -(-W // CELL)
        hits = [int(t) for t in hits]
        # per-cell candidate lists from tile bounds
        cells = [[] for _ in range(ncy * ncx)]
        for local, t in enumerate(hits):
            tb = mr._bounds[t]
            cx0 = max(int((tb[0] - xbase) // CELL), 0)
            cy0 = max(int((tb[1] - ybase) // CELL), 0)
            cx1 = min(int(np.ceil((tb[2] - xbase) / CELL)), ncx)
            cy1 = min(int(np.ceil((tb[3] - ybase) / CELL)), ncy)
            for cy in range(cy0, cy1):
                for cx in range(cx0, cx1):
                    cells[cy * ncx + cx].append(local)
        kmax = max((len(c) for c in cells), default=0)
        if kmax == 0:
            return None
        if kmax > K_CAP:
            return NotImplemented
        K = _pow2(kmax, 2)
        cands = np.full((ncy * ncx, K), -1, np.int32)
        for ci, lst in enumerate(cells):
            cands[ci, :len(lst)] = lst
        # tables + aux + sources
        stack = self._resident_stack(fillval)
        tabs = []
        aux = np.zeros((len(hits), 5), np.float32)
        src_list = []
        for local, t in enumerate(hits):
            eng = self._engine(t)
            sel = np.nonzero(
                (eng._tb[:, 0] < xbase + W) & (eng._tb[:, 2] > xbase) &
                (eng._tb[:, 1] < ybase + H) & (eng._tb[:, 3] > ybase))[0]
            tabs.append(eng._table_for_block(sel, (xbase, ybase), (0, 0),
                                             eng._w))
            tw, th = mr._tile_sizes[t]
            margin = mr._blend_margin
            if margin is None:
                margin = max(min(tw, th) / 16.0, 1.0)
            g, o = (1.0, 0.0)
            if mr._transfers is not None:
                g, o = mr._transfers[t]
            aux[local] = (tw, th, margin, g, o)
            if stack is None:
                src_list.append(self._tile_source(t, fillval))
        R = _pow2(max(t.shape[0] for t in tabs), _R_CHUNK)
        if R > 128:
            # dense tile meshes would unroll a huge raster loop; the host
            # path is the right tool there
            return NotImplemented
        Tp = _pow2(len(hits), 2)
        tables = np.zeros((Tp, R, 14), np.float32)
        tables[:, :, 2] = -2.0
        tables[:, :, 12] = -np.inf
        tables[:, :, 13] = -1.0
        for k, t in enumerate(tabs):
            tables[k, :t.shape[0]] = t
        auxp = np.zeros((Tp, 5), np.float32)
        auxp[:, :3] = 1.0            # avoid 0-div in padding tiles
        auxp[:len(hits)] = aux
        if stack is not None:
            packed = stack
            lows = self._resident_low() if pyramid else packed
            gmap = np.zeros(Tp, np.int32)
            gmap[:len(hits)] = hits
        else:
            hp, wp = self._ensure_tile_shape()
            srcs = np.full((Tp, hp, wp), fillval, np.uint8)
            for k, s in enumerate(src_list):
                srcs[k] = s
            packed = pack_tile_stack(jax.device_put(srcs))
            lows = (pack_low_stack(packed, jax.device_put(auxp[:, :2]),
                                   float(mr._pyramid_sigma))
                    if pyramid else packed)
            gmap = np.arange(Tp, dtype=np.int32)
        out_dev, cov_dev = montage_blend(
            packed, lows, jax.device_put(gmap), jax.device_put(tables),
            jax.device_put(auxp), jax.device_put(cands),
            jnp.float32(fillval), ncy=int(ncy), ncx=int(ncx),
            out_kind='u8', pyramid=pyramid)
        return out_dev, cov_dev, H, W

    @staticmethod
    def _fetch_block(disp):
        out_dev, cov_dev, H, W = disp
        if not bool(np.asarray(cov_dev)):
            return None
        return np.asarray(out_dev)[:H, :W]

    def render_block(self, bbox, hits, blend, fillval, **kwargs):
        """Device LINEAR/PYRAMID blend of one block; returns
        (array | None) or NotImplemented when the block needs the host
        path."""
        if not self.supported(blend):
            return NotImplemented
        disp = self._dispatch_block(bbox, hits, fillval, blend=blend)
        if disp is None or disp is NotImplemented:
            return disp
        return self._fetch_block(disp)

    def render_blocks(self, blocks, blend, fillval):
        """Pipelined multi-block render: each block's host prep overlaps
        earlier blocks' device compute; outputs fetch on a 2-thread pool
        (same scheduling that makes the section renderer link-bound,
        ops/render.py render_blocks). Returns a list aligned with
        ``blocks`` of array | None | NotImplemented (host fallback)."""
        if not self.supported(blend):
            return [NotImplemented] * len(blocks)
        from concurrent.futures import ThreadPoolExecutor
        mr = self._mr
        results = [None] * len(blocks)
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            futs = []
            for i, bbox in enumerate(blocks):
                hits = mr._index.query(bbox)
                if hits.size == 0:
                    continue
                disp = self._dispatch_block(bbox, hits, fillval,
                                            blend=blend)
                if disp is NotImplemented:
                    results[i] = NotImplemented
                elif disp is not None:
                    futs.append((i, pool.submit(self._fetch_block, disp)))
            for i, f in futs:
                results[i] = f.result()
        finally:
            pool.shutdown(wait=True)
        return results
