"""Smoke test of the stitch, window-solve and render path on one NVIDIA GPU.

Every phase drives the library through the calls the pipelines make, at
the sizes users run, and compares its result with a plain reference of
the same semantics. A miss in any phase exits non-zero and prints no
result line.

  device  platform, device kind and count; the card's name and power
          limit from nvidia-smi
  stitch  a 2x3 grid of 3000x4000 uint8 tiles cut from one seeded texture
          at known subpixel offsets with stage jitter: batched fused
          matching of the overlap crops with stage priors, the montage
          solve (translation, then elastic) and the device LINEAR blend
          of 2048^2 output blocks, against the ground truth
  xcorr   DoG prefilter + rFFT cross-correlation of 256 block pairs of
          128^2 (256^2 FFT) against scipy.fft, plus the DoG's device time
          from a profiler trace
  window  an 80-section, mesh_size 27 (~2M DOF) wrinkle-softened window
          solved on the stencil path against the exact cumulative drift;
          the stencil, gather and scatter FEM matvecs against each other
  render  2048^2 device render blocks through a deformed mesh at align
          density against crop_field + scipy map_coordinates(order=1)

With --four-cards only the sharded paths run, each against its one-card
result in the same process: the z-sharded window solve, the tile-sharded
montage solve and the pair-sharded batched matching.

Inputs come from --seed and stay in memory, so the script needs only
numpy, scipy and JAX. Run from the repository root:

    python chip_smoke.py [--seed 0] [--four-cards]

The last line of standard output is one JSON object naming the device.
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

MATMUL = 'float32, matmul precision highest'


class Report:
    """Prints each comparison with its tolerance and precision, records
    misses, and times device work (compile seconds from JAX's compile
    events, warm wall seconds ending in block_until_ready, peak device
    memory)."""

    def __init__(self):
        from jax import monitoring
        self.failures = []
        self._compile_s = 0.0
        self._monitoring = monitoring
        monitoring.register_event_duration_secs_listener(self._on_event)

    def close(self):
        self._monitoring.unregister_event_duration_listener(self._on_event)

    def _on_event(self, name, secs, **kwargs):
        if name.startswith('/jax/core/compile/'):
            self._compile_s += secs

    @staticmethod
    def line(phase, text):
        print(f'[{phase}] {text}', flush=True)

    def check(self, phase, what, value, ok, tolerance, precision=MATMUL):
        self.line(phase, f'{what}: {value} (tolerance {tolerance}; '
                         f'{precision}) {"ok" if ok else "FAIL"}')
        if not ok:
            self.failures.append(f'{phase}: {what}')

    def timed(self, phase, fn):
        """Run ``fn`` cold (compiling) and warm; return the warm result."""
        import jax

        def wait(out):
            jax.block_until_ready([x for x in jax.tree_util.tree_leaves(out)
                                   if isinstance(x, jax.Array)])
            return out

        c0 = self._compile_s
        t0 = time.perf_counter()
        wait(fn())
        cold = time.perf_counter() - t0
        compile_s = self._compile_s - c0
        t0 = time.perf_counter()
        out = wait(fn())
        warm = time.perf_counter() - t0
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get('peak_bytes_in_use', 'not available')
        self.line(phase, f'compile_s {compile_s:.3f} cold_wall_s {cold:.3f} '
                         f'wall_s {warm:.3f} peak_bytes_in_use {peak}')
        return out


# ----------------------------------------------------------------- inputs

def _bilinear_crop(world, x0, y0, h, w):
    """world sampled at (y0 + i, x0 + j), bilinear, rounded to uint8."""
    ix, iy = int(np.floor(x0)), int(np.floor(y0))
    fx, fy = x0 - ix, y0 - iy
    a = world[iy:iy + h + 1, ix:ix + w + 1].astype(np.float32)
    top = a[:-1, :-1] * (1 - fx) + a[:-1, 1:] * fx
    bot = a[1:, :-1] * (1 - fx) + a[1:, 1:] * fx
    return np.floor(top * (1 - fy) + bot * fy + 0.5).astype(np.uint8)


def make_tile_grid(rng, rows, cols, tile_h, tile_w, overlap, jitter,
                   margin=64):
    """Tiles cut from one seeded texture at subpixel true positions that
    differ from the nominal stage grid by ``jitter`` px (normal).
    Returns (world, tiles, true_xy (N, 2), stage_bboxes (N, 4))."""
    from feabas_tpu.utils.synthetic import texture
    H = 2 * margin + rows * tile_h - (rows - 1) * overlap
    W = 2 * margin + cols * tile_w - (cols - 1) * overlap
    world = texture(rng, H, W)
    tiles, true_xy, stage = [], [], []
    for r in range(rows):
        for c in range(cols):
            x0 = margin + c * (tile_w - overlap)
            y0 = margin + r * (tile_h - overlap)
            j = np.zeros(2) if r == c == 0 else np.clip(
                rng.normal(0, jitter, 2), -margin / 2, margin / 2)
            tx, ty = x0 + j[0], y0 + j[1]
            tiles.append(_bilinear_crop(world, tx, ty, tile_h, tile_w))
            true_xy.append((tx, ty))
            stage.append((x0, y0, x0 + tile_w, y0 + tile_h))
    return world, tiles, np.asarray(true_xy), np.asarray(stage, float)


def memory_tile_loader(tiles, bboxes):
    """A StaticImageLoader that serves in-memory tiles instead of files."""
    from feabas_tpu.dal import StaticImageLoader

    class MemoryTileLoader(StaticImageLoader):
        def _read_image(self, path):
            return tiles[int(path)]

    return MemoryTileLoader([str(i) for i in range(len(tiles))], bboxes,
                            dtype='uint8', number_of_channels=1)


def build_window(rng, S, mesh_size, extent=3000, wrinkle=True, ragged=False):
    """A window of S cartesian section meshes coupled by z-neighbor links
    whose offsets are a cumulative random drift (section 0 locked), so the
    exact solution is the pure translation u_z = -drift_z. ``wrinkle``
    softens a diagonal band per section (multiplier x0.02); ``ragged``
    alternates two mesh densities. Returns (meshes, system, drift)."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.parallel.window import build_stack_system
    meshes = []
    for z in range(S):
        ms = mesh_size if not (ragged and z % 2) else mesh_size * 0.75
        m = Mesh.from_bbox((0, 0, extent, extent), cartesian=True,
                           mesh_size=ms, uid=z, name=f'z{z}', resolution=4)
        m.set_translation((0, 0))
        meshes.append(m)
    meshes[0].locked = True
    drift = np.cumsum(rng.normal(0, 1.5, (S, 2)), axis=0)
    drift -= drift[0]
    g = np.linspace(extent / 30, extent - extent / 30, 12)
    xs, ys = np.meshgrid(g, g)
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    links = []
    for z in range(S - 1):
        q = pts + (drift[z + 1] - drift[z])
        tid0 = meshes[z].tri_finder(pts, gear='INITIAL', extrapolate=True)
        tid1 = meshes[z + 1].tri_finder(q, gear='INITIAL', extrapolate=True)
        links.append({
            'idx0': meshes[z].triangles[tid0],
            'bary0': meshes[z].cart2bary(pts, tid0, gear='INITIAL'),
            'idx1': meshes[z + 1].triangles[tid1],
            'bary1': meshes[z + 1].cart2bary(q, tid1, gear='INITIAL'),
            'weight': np.ones(len(pts), np.float32)})
    system = build_stack_system(meshes, links)
    if wrinkle:
        mult = np.asarray(system['multiplier']).copy()
        tris = np.asarray(system['tris'])
        for z in range(S):
            tz = tris if tris.ndim == 2 else tris[z]
            cent = np.asarray(system['verts0'][z])[tz].mean(axis=1)
            band = np.abs(cent[:, 0] - cent[:, 1]
                          - (z % 7 - 3) * extent / 20) < extent / 50
            mult[z, band] *= 0.02
        system['multiplier'] = mult
    return meshes, system, drift


def window_args(system, put):
    """stack_solve positional arguments, placed by ``put``."""
    return (put(system['verts0']), put(system['u']), put(system['tris']),
            put(system['multiplier']), put(system['poisson']),
            tuple(put(a) for a in system['links']), put(system['r_rest']),
            put(system['free']))


def drift_error(meshes, system, u, drift):
    """Per-vertex distance of the solved positions from the exact drift."""
    from feabas_tpu.parallel.window import stack_positions
    pos = stack_positions(system, np.asarray(u))
    return np.concatenate([
        np.linalg.norm(p - (m.vertices_w_offset('INITIAL') - drift[z]),
                       axis=-1)
        for z, (m, p) in enumerate(zip(meshes, pos))])


# ----------------------------------------------------------------- phases

def phase_device(report):
    """Device identity; returns the result's device dict."""
    import jax
    devs = jax.devices()
    d = devs[0]
    report.line('device', f'jax.devices() {devs}')
    report.line('device', f'platform {d.platform} device_kind '
                          f'{d.device_kind} count {len(devs)}')
    return {'platform': d.platform, 'kind': d.device_kind,
            'count': len(devs)}


def phase_stitch(report, seed, rows=2, cols=3, tile_h=3000, tile_w=4000,
                 overlap=400, block=2048, jitter=2.0):
    """Stitch one section through the Stitcher's calls; returns stats."""
    from feabas_tpu import config
    from feabas_tpu.stitcher import (MontageRenderer, Stitcher,
                                     match_list_of_overlaps)
    rng = np.random.default_rng(seed)
    world, tiles, true_xy, stage = make_tile_grid(
        rng, rows, cols, tile_h, tile_w, overlap, jitter)
    conf = config.stitch_configs()
    mconf, opt = conf['matching'], conf['optimization']
    names = [f'tile{i}' for i in range(len(tiles))]

    def run():
        loader = memory_tile_loader(tiles, stage)
        st = Stitcher(names, stage, resolution=4.0)
        overlaps = [tuple(int(i) for i in p) for p in
                    st.find_overlaps(mconf['min_overlap_width'])]
        for key, match, _, err in match_list_of_overlaps(
                loader, overlaps, mconf['margin'],
                dict(mconf['matcher_config'])):
            if err is not None:
                raise RuntimeError(f'overlap {key}: {err}')
            if match is not None:
                st.matches[key] = match
        st.initialize_meshes(**opt['mesh_settings'])
        st.initialize_optimizer(minweight=opt['minweight'])
        st.optimize_translation(**opt['translation'])
        st.optimize_elastic(**opt['final_elastic'])
        mr = MontageRenderer(st.meshes, loader, blend='LINEAR')
        x0, y0, x1, y1 = [int(np.floor(v)) for v in mr.bounds]
        blocks = [(x, y, x + block, y + block)
                  for y in range(y0, y1, block) for x in range(x0, x1, block)]
        outs = mr._montage_device_engine().render_blocks(
            blocks, 'LINEAR', float(loader.default_fillval))
        return st, overlaps, blocks, outs

    st, overlaps, blocks, outs = report.timed('stitch', run)
    report.line('stitch', f'{len(tiles)} tiles {tile_h}x{tile_w}, '
                          f'{len(overlaps)} overlaps, {len(st.matches)} '
                          f'matched, {len(blocks)} blocks {block}^2')
    report.check('stitch', 'overlaps matched', len(st.matches),
                 len(st.matches) == len(overlaps), 'all overlaps')
    res = []
    for (i, j), m in st.matches.items():
        res.append(np.linalg.norm((m.xy0 + true_xy[i])
                                  - (m.xy1 + true_xy[j]), axis=-1))
    res = np.concatenate(res)
    report.check('stitch', 'match residual vs ground truth, median px',
                 f'{np.median(res):.4f} (p90 {np.quantile(res, 0.9):.4f}, '
                 f'{res.size} matches)', np.median(res) <= 0.1, '<= 0.1 px')
    # solved tile translations against the truth, up to one global shift
    t = np.array([(m.vertices_w_offset('MOVING')
                   - m.vertices_w_offset('INITIAL')).mean(axis=0)
                  for m in st.meshes])
    shift = (true_xy - t).mean(axis=0)
    terr = np.linalg.norm(t + shift - true_xy, axis=-1)
    report.check('stitch', 'solved tile translation vs truth, max px',
                 f'{terr.max():.4f}', terr.max() <= 0.25, '<= 0.25 px')
    declined = sum(o is NotImplemented for o in outs)
    report.check('stitch', 'blocks rendered by the device blend',
                 f'{len(outs) - declined}/{len(outs)}', declined == 0, 'all')
    # blended montage against the world, inside the tiles' common interior
    diffs = []
    world_f = world.astype(np.float32)
    ix0, iy0 = true_xy.min(axis=0) + 16
    ix1, iy1 = true_xy.max(axis=0) + (tile_w - 16, tile_h - 16)
    for (bx0, by0, bx1, by1), out in zip(blocks, outs):
        if out is None or out is NotImplemented:
            continue
        gx = np.arange(bx0, bx1) + shift[0]
        gy = np.arange(by0, by1) + shift[1]
        sel_x = (gx >= ix0) & (gx < ix1 - 1)
        sel_y = (gy >= iy0) & (gy < iy1 - 1)
        if not sel_x.any() or not sel_y.any():
            continue
        wx0, wy0 = gx[sel_x][0], gy[sel_y][0]
        ref = _bilinear_crop(world_f, wx0, wy0, int(sel_y.sum()),
                             int(sel_x.sum()))
        got = out[np.ix_(sel_y, sel_x)]
        diffs.append(np.abs(got.astype(np.int16) - ref).ravel())
    diffs = np.concatenate(diffs)
    med, p99 = np.median(diffs), np.quantile(diffs, 0.99)
    report.check('stitch', 'device blend vs world, |diff| LSB',
                 f'median {med:.1f} p99 {p99:.1f} max {diffs.max()}, '
                 f'{(diffs > 8).mean():.2e} of {diffs.size} px above 8',
                 med <= 2 and p99 <= 8,
                 'median <= 2, p99 <= 8 LSB: tiles and output are rounded '
                 'to uint8 and the montage interpolates twice',
                 'uint8 output, f32 blend')
    return {'residual_median_px': float(np.median(res)),
            'blend_p99_lsb': float(p99)}


def _hlo_names_in_scope(hlo_text, scope):
    """Instruction names whose op_name metadata lies in ``scope``."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"')
    out = set()
    for ln in hlo_text.splitlines():
        m = pat.match(ln)
        if m and f'/{scope}/' in m.group(2) + '/':
            out.add(m.group(1))
    return out


def trace_device_time(fn, n_calls, hlo_text, scope, logdir):
    """Device time per call of ``fn`` and of its ops under the named
    ``scope``, from a jax.profiler trace: sums of the kernel events of the
    GPU planes (the CPU plane's XLA op events when there is no GPU).
    Returns (total_ms, scope_ms, n_scope_events)."""
    import jax
    from jax.profiler import ProfileData
    names = _hlo_names_in_scope(hlo_text, scope)
    with jax.profiler.trace(logdir):
        for _ in range(n_calls):
            jax.block_until_ready(fn())
    path = sorted(glob.glob(os.path.join(logdir, '**', '*.xplane.pb'),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    planes = [p for p in prof.planes if p.name.startswith('/device:GPU')]
    if not planes:
        planes = [p for p in prof.planes if p.name == '/host:CPU']
    total = in_scope = 0.0
    n_scope = 0
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = {k: str(v) for k, v in ev.stats}
                op = stats.get('hlo_op')
                if op is None:
                    continue
                total += ev.duration_ns
                if op in names or f'/{scope}/' in stats.get('tf_op', ''):
                    in_scope += ev.duration_ns
                    n_scope += 1
    return total / n_calls / 1e6, in_scope / n_calls / 1e6, n_scope


def make_block_pairs(rng, n, h, w, max_shift=10.0, margin=24):
    """n uint8 block pairs; img1 is img0's texture displaced by a known
    subpixel (dy, dx): img1(y, x) = base(y + dy, x + dx)."""
    from scipy.ndimage import gaussian_filter, map_coordinates
    base = gaussian_filter(rng.normal(0, 1, (n, h + 2 * margin,
                                             w + 2 * margin)), (0, 2, 2))
    base = base / base.std() * 40 + 128
    shifts = rng.uniform(-max_shift, max_shift, (n, 2))
    gy, gx = np.meshgrid(np.arange(h) + margin, np.arange(w) + margin,
                         indexing='ij')
    img0 = np.empty((n, h, w), np.uint8)
    img1 = np.empty((n, h, w), np.uint8)
    for i, (dy, dx) in enumerate(shifts):
        img0[i] = np.clip(np.floor(base[i, margin:margin + h,
                                        margin:margin + w] + 0.5), 0, 255)
        s = map_coordinates(base[i], [gy + dy, gx + dx], order=3)
        img1[i] = np.clip(np.floor(s + 0.5), 0, 255)
    return img0, img1, shifts


def phase_xcorr(report, seed, n=256, h=128, w=128, fft=256, chunk=128,
                sigma=2.5, trace_dir=None):
    """The matcher's xcorr core against scipy; returns stats."""
    import functools
    import jax
    import jax.numpy as jnp
    from bench import _cpu_reference
    from feabas_tpu import constant as const
    from feabas_tpu.ops import xcorr
    from feabas_tpu.ops.filters import masked_dog_filter
    rng = np.random.default_rng(seed)
    img0, img1, shifts = make_block_pairs(rng, n, h, w)
    fftshp = (fft, fft)
    mask = jnp.ones((1, h, w), jnp.float32)

    # the final match round's configuration: quadratic subpixel fit on
    # the overlap-envelope-normalized surface; integer peaks come from
    # the raw surface, which is what the scipy reference computes
    @functools.partial(jax.jit, static_argnames=('subpixel', 'chunk'))
    def step(a_u8, b_u8, subpixel, chunk):
        with jax.named_scope('dog_prefilter'):
            a = masked_dog_filter(a_u8.astype(jnp.float32), sigma)
            b = masked_dog_filter(b_u8.astype(jnp.float32), sigma)
        norm = 'peak' if subpixel else False
        outs = [xcorr._xcorr_core(a[k:k + chunk], b[k:k + chunk], mask,
                                  mask, fftshp, (h, w), (h, w),
                                  const.FFT_CONF_MIRROR, subpixel, norm)
                for k in range(0, a.shape[0], chunk)]
        return tuple(jnp.concatenate(o) for o in zip(*outs))

    d0, d1 = jnp.asarray(img0), jnp.asarray(img1)
    dx, dy, _ = report.timed('xcorr', lambda: step(d0, d1, True, chunk))
    ix, iy, _ = step(d0, d1, False, chunk)
    idx, _ = _cpu_reference(img0, img1, sigma=sigma)
    ry, rx = np.divmod(idx, fft)
    ry = (ry + fft // 2) % fft - fft // 2
    rx = (rx + fft // 2) % fft - fft // 2
    same = (np.asarray(iy) == ry) & (np.asarray(ix) == rx)
    report.check('xcorr', 'integer peaks equal to scipy.fft',
                 f'{int(same.sum())}/{n}', bool(same.all()), 'all equal')
    truth = -shifts[:, ::-1]                                  # (dx, dy)

    def sub_err(x, y):
        return np.linalg.norm(np.stack([np.asarray(x), np.asarray(y)], -1)
                              - truth, axis=-1)

    err = sub_err(dx, dy)
    ux, uy, _ = step(d0, d1, True, n)
    err_un = sub_err(ux, uy)
    report.line('xcorr', f'subpixel error median px: batch {chunk} '
                         f'{np.median(err):.4f}, unchunked batch {n} '
                         f'{np.median(err_un):.4f} (max |difference| '
                         f'{np.abs(err - err_un).max():.2e} px)')
    report.check('xcorr', f'subpixel error vs known shifts, median px '
                          f'(batch {chunk})', f'{np.median(err):.4f}',
                 np.median(err) <= 0.1, '<= 0.1 px')
    out = {'subpixel_median_px': float(np.median(err)),
           'subpixel_median_px_unchunked': float(np.median(err_un))}
    if trace_dir is not None:
        hlo = step.lower(d0, d1, True, chunk).compile().as_text()
        total, dog, nev = trace_device_time(
            lambda: step(d0, d1, True, chunk), 5, hlo, 'dog_prefilter',
            trace_dir)
        report.line('xcorr', f'trace: step device time {total:.3f} ms, '
                             f'DoG prefilter {dog:.3f} ms ({nev} kernel '
                             f'events in 5 calls)')
        out.update(step_device_ms=total, dog_device_ms=dog)
    return out


def phase_window(report, seed, S=80, mesh_size=27, extent=3000,
                 maxiter=2000):
    """The align stage's production window on the stencil path."""
    import jax
    import jax.numpy as jnp
    from feabas_tpu.ops import fem
    from feabas_tpu.parallel.window import build_link_transpose, stack_solve
    rng = np.random.default_rng(seed)
    meshes, system, drift = build_window(rng, S, mesh_size, extent)
    grid = system.get('grid_shape')
    assert grid is not None, 'the window meshes must lattice-pack'
    V = system['u'].shape[1]
    args = window_args(system, jnp.asarray)
    linc = tuple(jnp.asarray(a) for a in
                 build_link_transpose(system['links'], S, V))
    sten = jnp.asarray(system['sten'])
    u, n_it, res = report.timed('window', lambda: stack_solve(
        *args, lam_s=0.1, maxiter=maxiter, grid_shape=grid, linc=linc,
        sten=sten))
    err = drift_error(meshes, system, u, drift)
    report.line('window', f'{S} sections, {int(system["u"].size)} DOF, '
                          f'{int(n_it)} iterations, final residual '
                          f'{float(res):.3e}')
    report.check('window', 'vertex error vs exact drift, max px',
                 f'{err.max():.4f} (median {np.median(err):.4f})',
                 err.max() <= 0.1, '<= 0.1 px at every vertex')

    tris = args[2]
    inc, imask = (jnp.asarray(a) for a in fem.build_incidence(
        np.asarray(system['tris']), V))

    @jax.jit
    def matvecs(verts0, mult, poisson, x):
        B, area2 = jax.vmap(lambda v0: fem.shape_matrices(v0[tris]))(verts0)
        Ke = jax.vmap(fem.eng_element_stiffness)(B, area2, mult, poisson)
        C = jax.vmap(lambda K: fem.stencil_assemble_gather(K, sten))(Ke)
        ys = jax.vmap(lambda xi, Ci: fem.stiffness_matvec_stencil(
            xi, Ci, *grid))(x, C)
        yg = jax.vmap(lambda xi, Ki: fem.stiffness_matvec_gather(
            xi, Ki, tris, inc, imask))(x, Ke)
        yp = jax.vmap(lambda xi, Ki: fem.stiffness_matvec(xi, Ki, tris))(
            x, Ke)
        return ys, yg, yp

    x = jnp.asarray(rng.normal(0, 1, system['u'].shape).astype(np.float32))
    ys, yg, yp = (np.asarray(a, np.float64) for a in
                  matvecs(args[0], args[3], args[4], x))
    scale = np.abs(yp).max()
    rel_s = np.abs(ys - yp).max() / scale
    rel_g = np.abs(yg - yp).max() / scale
    report.check('window', 'matvec forms, max |stencil - scatter| / '
                           'max |scatter|', f'{rel_s:.2e}', rel_s <= 1e-5,
                 '<= 1e-5')
    report.check('window', 'matvec forms, max |gather - scatter| / '
                           'max |scatter|', f'{rel_g:.2e}', rel_g <= 1e-5,
                 '<= 1e-5')
    return {'dof': int(system['u'].size), 'iterations': int(n_it),
            'max_err_px': float(err.max())}


def phase_render(report, seed, size=8192, block=2048, n_blocks=4,
                 mesh_size=None):
    """Device section render against crop_field + map_coordinates."""
    from scipy.ndimage import map_coordinates
    from feabas_tpu import config
    from feabas_tpu.dal import StreamLoader
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.utils.synthetic import texture
    rng = np.random.default_rng(seed)
    if mesh_size is None:
        mesh_size = config.align_configs()['meshing']['mesh_size']
    world = texture(rng, size, size)
    mesh = Mesh.from_bbox((0, 0, size, size), cartesian=True,
                          mesh_size=mesh_size, resolution=4)
    v = mesh.vertices(1)
    amp = size / 1600
    mesh.set_vertices(v + np.stack([amp * np.sin(v[:, 1] / (size / 14)),
                                    amp * np.cos(v[:, 0] / (size / 16))], -1),
                      1, offset=mesh.offset(1))
    r = MeshRenderer.from_mesh(mesh, image_loader=StreamLoader(world))
    c = size // 2
    k = int(np.ceil(np.sqrt(n_blocks)))
    bboxes = [(c + (i % k - k / 2) * block, c + (i // k - k / 2) * block,
               c + (i % k - k / 2 + 1) * block,
               c + (i // k - k / 2 + 1) * block) for i in range(n_blocks)]
    bboxes = [tuple(int(b) for b in bb) for bb in bboxes]
    outs = report.timed('render', lambda: [r.crop(b, device_render=True)
                                           for b in bboxes])
    report.check('render', 'blocks rendered by the device program',
                 r._dev_engine is not None, r._dev_engine is not None,
                 'device path taken')
    world_f = world.astype(np.float32)
    frac, worst = [], 0
    for bb, out in zip(bboxes, outs):
        mx, my, mask = r.crop_field(bb)
        ref = map_coordinates(world_f, [np.nan_to_num(my), np.nan_to_num(mx)],
                              order=1, mode='constant', cval=0.0)
        ref = np.floor(ref + 0.5)
        d = np.abs(out.astype(np.float32) - ref)[mask]
        frac.append((d <= 1).mean())
        worst = max(worst, int(d.max()))
    report.check('render', 'pixels within 1 LSB of the scipy reference',
                 f'{min(frac):.5f} (worst block; max |diff| {worst})',
                 min(frac) >= 0.999, '>= 0.999 of masked pixels',
                 'uint8 output, f32 coordinates quantized to 1/32 px')
    return {'frac_within_1lsb': float(min(frac))}


# ----------------------------------------------------------------- 4 cards

def _collectives(hlo_text):
    ops = ('all-reduce', 'collective-permute', 'all-gather')
    return {k: len(re.findall(rf'\s{k}(?:-start)?\(', hlo_text))
            for k in ops}


def four_card_window(report, seed, devices, S=80, mesh_size=27,
                     extent=3000, maxiter=2000, ragged=False):
    """z-sharded window solve against the same solve on one card, set up
    as ``parallel.window.multihost_window_solve`` does."""
    import jax
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.parallel.window import (build_link_transpose,
                                            pad_stack_sections,
                                            shard_stack_system, stack_solve)
    rng = np.random.default_rng(seed)
    meshes, system, drift = build_window(rng, S, mesh_size, extent,
                                         ragged=ragged)
    n = len(devices)
    system = pad_stack_sections(system, n)
    Sp, V = system['u'].shape[:2]
    system['linc'] = build_link_transpose(system['links'], Sp, V)
    grid = system.get('grid_shape')

    def solve(a):
        return stack_solve(a['verts0'], a['u'], a['tris'], a['multiplier'],
                           a['poisson'], a['links'], a['r_rest'], a['free'],
                           lam_s=0.1, maxiter=maxiter, grid_shape=grid,
                           linc=a.get('linc'), sten=a.get('sten'))

    one = {k: (tuple(jax.device_put(x, devices[0]) for x in v)
               if isinstance(v, tuple) else jax.device_put(v, devices[0]))
           for k, v in system.items()
           if k in ('verts0', 'u', 'tris', 'multiplier', 'poisson', 'links',
                    'r_rest', 'free', 'linc', 'sten') and v is not None}
    u1, it1, _ = solve(one)
    sh = shard_stack_system(system, JMesh(np.asarray(devices), ('z',)))
    placed = {d for a in (sh['u'], sh['multiplier'], sh['links'][0])
              for d in a.sharding.device_set}
    shards = {tuple(s.data.shape) for s in sh['u'].addressable_shards}
    report.check('four-cards', 'window arrays placed on devices',
                 f'{len(placed)} devices, u shards {sorted(shards)}',
                 len(placed) == n and shards == {(Sp // n, V, 2)},
                 f'{n} devices, {Sp // n} sections per shard', 'placement')
    un, itn, _ = report.timed('four-cards', lambda: solve(sh))
    hlo = stack_solve.lower(
        sh['verts0'], sh['u'], sh['tris'], sh['multiplier'], sh['poisson'],
        sh['links'], sh['r_rest'], sh['free'], lam_s=0.1, maxiter=maxiter,
        grid_shape=grid, linc=sh.get('linc'),
        sten=sh.get('sten')).compile().as_text()
    report.line('four-cards', f'window solve ({Sp} sections, '
                              f'{"stencil" if grid else "scatter"} matvec) '
                              f'collectives in compiled HLO: '
                              f'{_collectives(hlo)}')
    diff = np.abs(np.asarray(un, np.float64) - np.asarray(u1)).max()
    # the two programs sum in different orders, so CG may stop a few
    # iterations apart: agreement is bounded at a tenth of the parity bound
    report.check('four-cards', f'window displacement, {n} cards vs 1, '
                               'max |diff| px',
                 f'{diff:.2e} (iterations {int(itn)} vs {int(it1)})',
                 diff <= 1e-2, '<= 0.01 px')
    err = drift_error(meshes, system, un, drift)
    report.check('four-cards', 'sharded window vertex error vs exact '
                               'drift, max px', f'{err.max():.4f}',
                 err.max() <= 0.1, '<= 0.1 px')


def _montage_slm(rng, rows, cols, tile_h, tile_w, overlap, mesh_size):
    """An exactly consistent montage: tiles at jittered grid positions,
    links between neighbors at their true relative offsets."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.optimizer import SLM
    tiles, pos = [], {}
    for i in range(rows * cols):
        r, c = divmod(i, cols)
        m = Mesh.from_boarder_bbox((0, 0, tile_w, tile_h), bd_width=overlap,
                                   mesh_size=mesh_size, uid=i, name=f't{i}',
                                   resolution=4)
        t = np.array([c * (tile_w - overlap), r * (tile_h - overlap)],
                     float) + rng.normal(0, 2.0, 2)
        m.set_translation(t, gear=(-1, 0))
        m.set_translation(t, gear=(-1, 1))
        tiles.append(m)
        pos[i] = (r, c)
    tiles[0].locked = True
    slm = SLM(tiles)
    g = np.linspace(0.1, 0.9, 5)
    for i in range(rows * cols):
        r, c = pos[i]
        if c + 1 < cols:
            p = np.stack([np.full_like(g, tile_w - overlap / 2),
                          g * tile_h], -1)
            slm.add_link_from_coordinates(
                i, i + 1, p, p - [tile_w - overlap, 0.0], gear=(-1, -1))
        if r + 1 < rows:
            p = np.stack([g * tile_w,
                          np.full_like(g, tile_h - overlap / 2)], -1)
            slm.add_link_from_coordinates(
                i, i + cols, p, p - [0.0, tile_h - overlap], gear=(-1, -1))
    return slm


def four_card_montage(report, seed, devices, rows=8, cols=8, tile_h=3000,
                      tile_w=4000, overlap=400, mesh_size=300):
    """Tile-sharded montage solve against the same solve on one card."""
    from jax.sharding import Mesh as JMesh
    from feabas_tpu.parallel import montage
    n = len(devices)
    out = {}
    for k in (1, n):
        slm = _montage_slm(np.random.default_rng(seed), rows, cols, tile_h,
                           tile_w, overlap, mesh_size)
        jmesh = JMesh(np.asarray(devices[:k]), ('m',))
        if k == n:
            system = montage.slm_montage_to_tiles(slm)
            padded = montage.pad_montage_system(system, n)
            sh = montage.shard_montage_system(padded, jmesh)
            placed = sh['u'].sharding.device_set
            report.check('four-cards', 'montage tile arrays placed on '
                                       'devices', f'{len(placed)} devices',
                         len(placed) == n, f'{n} devices', 'placement')
        res = montage.sharded_montage_linear_solve(
            slm, 1.0, maxiter=2000, device_mesh=jmesh)
        assert res is not None, 'the montage must bucket'
        out[k] = (res, np.concatenate([m.vertices_w_offset('MOVING')
                                       for m in slm.meshes]))
    diff = np.abs(out[n][1] - out[1][1]).max()
    report.check('four-cards', f'montage positions, {n} cards vs 1, max '
                               '|diff| px', f'{diff:.2e}', diff <= 1e-2,
                 '<= 0.01 px')
    cost1 = out[n][0][1]
    report.check('four-cards', 'montage residual cost after the sharded '
                               'solve', f'{cost1:.2e}', cost1 < 0.1, '< 0.1')


def four_card_matching(report, seed, devices, n_pairs=16, h=3000, w=608):
    """Pair-sharded batched matching against one-pair dispatches on one
    card and against the known shifts."""
    import jax
    from feabas_tpu import config
    from feabas_tpu.matcher import match_pairs_batched, stitching_matcher
    from feabas_tpu.utils.synthetic import texture
    rng = np.random.default_rng(seed)
    mc = dict(config.stitch_configs()['matching']['matcher_config'])
    jobs, shifts = [], []
    for k in range(n_pairs):
        img0 = texture(rng, h, w)
        sh = (4 + (k % 3), -2 - (k % 2))
        img1 = np.roll(np.roll(img0, -sh[1], axis=0), -sh[0], axis=1)
        jobs.append((img0, img1,
                     dict(mc, stage_prior=(sh[0] + 1.0, sh[1] - 1.0))))
        shifts.append(sh)
    report.line('four-cards', f'batched matching shards {n_pairs} pairs '
                              f'over {jax.local_device_count()} local '
                              f'devices')
    batched = report.timed('four-cards', lambda: match_pairs_batched(jobs))
    with jax.default_device(devices[0]):
        single = [stitching_matcher(a, b, **kw) for a, b, kw in jobs]
    diffs, errs = [], []
    for mb, ms, sh in zip(batched, single, shifts):
        assert mb is not None and ms is not None, 'a pair failed to match'
        assert mb.xy0.shape == ms.xy0.shape, 'match counts differ'
        diffs.append(np.linalg.norm(mb.xy0 - ms.xy0, axis=-1))
        errs.append(np.median(np.linalg.norm(mb.xy0 - (mb.xy1 + sh),
                                             axis=-1)))
    diffs = np.concatenate(diffs)
    # the batched (vmapped, sharded) and one-pair programs sum in
    # different orders; low-confidence blocks may move by a fraction of
    # a pixel, the bulk must agree
    report.check('four-cards', 'batched matches vs one-card single-pair '
                               'matches, median |diff| px',
                 f'{np.median(diffs):.2e} (max {diffs.max():.2e})',
                 np.median(diffs) <= 1e-2, '<= 0.01 px')
    report.check('four-cards', 'batched match error vs known shifts, '
                               'worst pair median px', f'{max(errs):.4f}',
                 max(errs) <= 0.1, '<= 0.1 px')


# ------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the sharded paths, on four cards')
    args = ap.parse_args(argv)

    from feabas_tpu import config
    config.enable_compile_cache()
    import jax
    report = Report()
    device = phase_device(report)
    if device['platform'] != 'gpu':
        print(f'chip_smoke: needs an NVIDIA GPU, JAX found '
              f'{device["platform"]}', file=sys.stderr)
        return 2
    from bench import nvidia_smi
    report.line('device', f'nvidia-smi {nvidia_smi()}')
    if args.four_cards:
        devices = jax.devices()[:4]
        if len(devices) != 4:
            print(f'chip_smoke: --four-cards needs 4 GPUs, found '
                  f'{len(devices)}', file=sys.stderr)
            return 2
        four_card_window(report, args.seed, devices)
        four_card_montage(report, args.seed, devices)
        four_card_matching(report, args.seed, devices)
    else:
        phase_stitch(report, args.seed)
        with tempfile.TemporaryDirectory() as trace_dir:
            phase_xcorr(report, args.seed, trace_dir=trace_dir)
        phase_window(report, args.seed)
        phase_render(report, args.seed)
    report.close()
    if report.failures:
        print('chip_smoke: failed: ' + '; '.join(report.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': device}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
