"""Device render path (ops/render.py): on-device rasterize+warp parity
against the host cv2 path (reference workload: feabas/renderer.py:566-683).
"""

import numpy as np
import pytest


def _smooth_mesh(N=512, mesh_size=64, amp=4.0):
    from feabas_tpu.mesh import Mesh
    m = Mesh.from_bbox((0, 0, N, N), cartesian=True, mesh_size=mesh_size,
                       resolution=4)
    v = m.vertices(1)
    m.set_vertices(v + np.stack([amp * np.sin(v[:, 1] / 97),
                                 amp * np.cos(v[:, 0] / 83)], -1), 1,
                   offset=m.offset(1))
    return m


def _world(N=512, seed=3, pad=0):
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter
    w = gaussian_filter(rng.normal(0, 1, (N + pad, N + pad)), 1.5)
    return (w / w.std() * 40 + 128).clip(0, 255).astype(np.uint8)


def _compare(host, dev, max_mismatch_frac=2e-3, lsb=1):
    """Device vs host blocks: identical shape/dtype; all but a thin
    rasterization-edge band within ``lsb``; the band itself tiny."""
    assert host.shape == dev.shape and host.dtype == dev.dtype
    diff = np.abs(host.astype(np.int32) - dev.astype(np.int32))
    bad = diff > lsb
    frac = bad.mean()
    assert frac <= max_mismatch_frac, (frac, diff.max())


def test_device_crop_matches_host_smooth(workdir):
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh()
    loader = StreamLoader(_world())
    r = MeshRenderer.from_mesh(m, image_loader=loader)
    bbox = (-16, -16, 300, 280)   # includes uncovered margin
    host = r.crop(bbox, device_render=False)
    dev = r.crop(bbox, device_render=True)
    _compare(host, dev)
    # uncovered margin is fillval on both
    assert (dev[:8, :8] == host[:8, :8]).all()


def test_device_crop_multiple_and_pipelining(workdir):
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh()
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world()))
    bboxes = [(0, 0, 256, 256), (256, 0, 512, 256), (0, 256, 256, 512)]
    host = r.crop_multiple(bboxes, device_render=False)
    dev = r.crop_multiple(bboxes, device_render=True)
    for hb, db in zip(host, dev):
        _compare(hb, db)


def test_device_crop_nonstream_loader_blockwise_source(workdir, tmp_path):
    """Non-StreamLoader sources exercise the per-block source-crop upload
    path."""
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StaticImageLoader
    from feabas_tpu import common
    img = _world(N=400)
    fn = str(tmp_path / 'tile.png')
    common.imwrite(fn, img)
    loader = StaticImageLoader([fn], bboxes=[(0, 0, 400, 400)])
    m = _smooth_mesh(N=400)
    r = MeshRenderer.from_mesh(m, image_loader=loader)
    bbox = (0, 0, 400, 400)
    host = r.crop(bbox, device_render=False, fileid=0)
    dev = r.crop(bbox, device_render=True, fileid=0)
    _compare(host, dev)


def test_device_crop_folded_mesh_least_deform(workdir):
    """Folded mesh with LEAST_DEFORM arbitration + geodesic masking: the
    fold-ambiguous zone masks identically and values match off the fold."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    img = _world(N=128)[:60, :]
    m = Mesh.from_bbox((0, 0, 120, 60), cartesian=True, mesh_size=20)
    v = m.vertices('FIXED').copy()
    sel = v[:, 0] > 80
    v[sel, 0] = 160 - v[sel, 0]
    m.set_vertices(v, 'MOVING')
    loader = StreamLoader(img[:, :120])
    for kw in ({'mode': 'LEAST_DEFORM'},
               {'mode': 'LEAST_DEFORM', 'geodesic_mask': True}):
        r = MeshRenderer.from_mesh(m, image_loader=loader, **kw)
        host = r.crop((0, 0, 120, 60), device_render=False)
        dev = r.crop((0, 0, 120, 60), device_render=True)
        _compare(host, dev, max_mismatch_frac=0.02)


def test_device_crop_weight_threshold_and_empty(workdir):
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh(N=256)
    loader = StreamLoader(_world(N=256))
    r = MeshRenderer.from_mesh(m, image_loader=loader)
    # a threshold above every weight masks everything -> empty
    blk = r.crop((0, 0, 128, 128), device_render=True, return_empty=True,
                 render_weight_threshold=10.0)
    assert blk is None
    # bbox fully outside the mesh -> empty
    blk = r.crop((5000, 5000, 5128, 5128), device_render=True,
                 return_empty=True)
    assert blk is None
    # without return_empty: fillval block
    blk = r.crop((5000, 5000, 5128, 5128), device_render=True, fillval=7)
    assert blk.shape == (128, 128) and (blk == 7).all()


def test_device_render_fallbacks(workdir):
    """log_sigma / non-LINEAR interp fall back to the host path (results
    still correct)."""
    import cv2
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh(N=256)
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world(N=256)))
    a = r.crop((0, 0, 128, 128), device_render=True, log_sigma=2.5)
    b = r.crop((0, 0, 128, 128), device_render=False, log_sigma=2.5)
    assert np.allclose(a, b)
    a = r.crop((0, 0, 128, 128), device_render=True,
               interpolation=cv2.INTER_NEAREST)
    b = r.crop((0, 0, 128, 128), device_render=False,
               interpolation=cv2.INTER_NEAREST)
    assert (a == b).all()


def test_device_render_config_default(workdir):
    """general_configs device.render drives the default routing."""
    from feabas_tpu import config
    from feabas_tpu.renderer import resolve_device_render
    mode = config.device_render()
    assert mode in (False, True, 'hybrid', 'auto')
    # resolution maps every config value onto a concrete route; on the
    # CPU test backend 'auto' resolves to the host path (no accelerator)
    assert resolve_device_render(mode) in (False, True, 'hybrid')
    assert resolve_device_render('auto') in (False, 'hybrid')
    assert resolve_device_render('hybrid') == 'hybrid'
    assert resolve_device_render(True) is True
    assert resolve_device_render(False) is False


def test_render_whole_mesh_device_stays_in_process(workdir, tmp_path,
                                                   monkeypatch):
    """render_whole_mesh with device_render=True pipelines tile waves
    in-process (the chip is one exclusive resource) even when
    num_workers > 1, and the tiles match the host fan-out result."""
    import feabas_tpu.renderer as renderer_mod
    from feabas_tpu.renderer import render_whole_mesh
    from feabas_tpu.dal import StreamLoader
    from feabas_tpu.common import imread

    def _boom(*a, **k):
        raise AssertionError('worker fan-out must not run for device render')

    m = _smooth_mesh(N=300, mesh_size=60)
    loader = StreamLoader(_world(N=300))
    host = render_whole_mesh(m, loader, str(tmp_path / 'h' / 's'),
                             tile_size=(128, 128), device_render=False)
    monkeypatch.setattr(renderer_mod, 'subprocess_render_mesh_tiles', _boom)
    dev = render_whole_mesh(m.copy(), loader, str(tmp_path / 'd' / 's'),
                            tile_size=(128, 128), device_render=True,
                            num_workers=4, tiles_per_job=2)
    assert len(dev) == len(host) > 0
    hmap = {fn.split('/h/')[-1]: fn for fn in host}
    dmap = {fn.split('/d/')[-1]: fn for fn in dev}
    assert set(hmap) == set(dmap)
    for key in hmap:
        _compare(imread(hmap[key]), imread(dmap[key]))


def test_volume_render_device_stays_in_process(workdir, tmp_path, rng,
                                               monkeypatch):
    """VolumeRenderer(device_render=True) with num_workers>1 renders
    in-process (no subprocess fan-out) and the volume matches the host
    multi-worker run."""
    from feabas_tpu.mesh import Mesh
    from feabas_tpu.dal import TensorStoreWriter, StreamLoader
    import feabas_tpu.renderer as renderer_mod
    from feabas_tpu.renderer import VolumeRenderer
    h = w = 160
    from scipy.ndimage import gaussian_filter
    base = gaussian_filter(rng.normal(0, 1, (h + 40, w + 40)), 1.5)
    base = (base / base.std() * 40 + 128).clip(0, 255).astype(np.uint8)
    drift = np.array([[0, 0], [5, -3]], float)

    def _build():
        tform_list, loaders = [], {}
        for z in range(2):
            img = base[20 + int(drift[z][1]):20 + int(drift[z][1]) + h,
                       20 + int(drift[z][0]):20 + int(drift[z][0]) + w]
            name = f's{z}'
            loaders[name] = StreamLoader(img)
            mesh = Mesh.from_bbox((0, 0, w, h), cartesian=True,
                                  mesh_size=40, name=name, uid=z)
            mesh.set_translation(drift[z])
            tform_list.append((z, name, mesh))
        return tform_list, loaders

    def _boom(*a, **k):
        raise AssertionError('worker fan-out must not run for device render')

    tform_list, loaders = _build()
    out_h = str(tmp_path / 'vol_host')
    wr_h = TensorStoreWriter.create(out_h, (0, 0, w + 20, h + 20), 2,
                                    driver='neuroglancer_precomputed',
                                    chunk_shape=[64, 64, 1])
    VolumeRenderer(tform_list, loaders, wr_h,
                   flag_dir=str(tmp_path / 'fh')).render_volume()

    monkeypatch.setattr(renderer_mod, 'subprocess_render_volume_slab', _boom)
    monkeypatch.setattr(renderer_mod, 'subprocess_render_volume_chunks',
                        _boom)
    tform_list, loaders = _build()
    out_d = str(tmp_path / 'vol_dev')
    wr_d = TensorStoreWriter.create(out_d, (0, 0, w + 20, h + 20), 2,
                                    driver='neuroglancer_precomputed',
                                    chunk_shape=[64, 64, 1])
    n = VolumeRenderer(tform_list, loaders, wr_d, device_render=True,
                       flag_dir=str(tmp_path / 'fd')).render_volume(
                           num_workers=2, chunks_per_job=2)
    assert n > 0
    for z in range(2):
        a = wr_h.read_chunk((0, 0, w + 20, h + 20), z)
        b = wr_d.read_chunk((0, 0, w + 20, h + 20), z)
        _compare(np.asarray(a), np.asarray(b))


def test_hybrid_render_matches_host(workdir):
    """'hybrid' routing: host + device lanes drain one work queue; the
    assembled section must match the host-only render within the device
    path's LSB contract for device-claimed blocks and exactly for
    host-claimed ones."""
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh(N=1024, mesh_size=128)
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world(N=1024)))
    tiles = [(x, y, x + 256, y + 256)
             for y in range(0, 1024, 256) for x in range(0, 1024, 256)]
    host = r.crop_multiple(tiles, return_empty=True, device_render=False)
    hyb = r.crop_multiple(tiles, return_empty=True, device_render='hybrid')
    assert len(hyb) == len(host)
    for hb, yb in zip(host, hyb):
        assert (hb is None) == (yb is None)
        if hb is not None:
            _compare(hb, yb)


def test_group_cap_batched_dispatch_matches(workdir):
    """group_cap > 1 exercises the vmapped multi-block programs (the
    local-link dispatch mode; cap 1 is the slow-link mode)."""
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh(N=512, mesh_size=64)
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world()))
    tiles = [(x, y, x + 128, y + 128)
             for y in range(0, 512, 128) for x in range(0, 512, 128)]
    cap1 = r.crop_multiple(tiles, return_empty=True, device_render=True,
                           group_cap=1)
    cap4 = r.crop_multiple(tiles, return_empty=True, device_render=True,
                           group_cap=4)
    for a, b in zip(cap1, cap4):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a == b).all()      # same program math, same grouping key


def test_resolve_group_cap_probe(workdir):
    """'auto' group cap follows the measured link profile."""
    from feabas_tpu.ops import link_probe
    from feabas_tpu.ops.render import resolve_group_cap
    try:
        link_probe.set_profile_for_testing(
            {'platform': 'gpu', 'latency_s': 0.12,
             'down_MBps': 40.0, 'up_MBps': 54.0})
        assert resolve_group_cap('auto') == 1       # slow-link regime
        # size-aware auto: tiny blocks batch until the group carries
        # ~1M output px REGARDLESS of link (dispatch-cost amortization)
        assert resolve_group_cap('auto', block_pixels=128 * 128) == 16
        assert resolve_group_cap('auto', block_pixels=2048 * 2048) == 1
        link_probe.set_profile_for_testing(
            {'platform': 'gpu', 'latency_s': 2e-4,
             'down_MBps': 8000.0, 'up_MBps': 8000.0})
        assert resolve_group_cap('auto') == 4       # local link
        assert resolve_group_cap('auto', block_pixels=128 * 128) == 16
        assert resolve_group_cap('auto', block_pixels=512 * 512) == 4
        assert resolve_group_cap(2) == 2
        assert resolve_group_cap(2, block_pixels=128 * 128) == 2  # explicit
    finally:
        link_probe.set_profile_for_testing(None)


def test_fused_mips_match_host_chain(workdir):
    """render->mip fusion: each tile comes back as (mip0, .., mipK); the
    fused mip levels must match the host chain (GaussianBlur + 2x
    INTER_AREA on the written mip0) to within rounding at the interior
    (the device blur uses edge padding vs cv2 reflect at borders)."""
    import cv2
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    m = _smooth_mesh(N=1024, mesh_size=128)
    r = MeshRenderer.from_mesh(m, image_loader=StreamLoader(_world(N=1024)))
    tiles = [(0, 0, 512, 512), (512, 0, 1024, 512)]
    fused = r.crop_multiple(tiles, return_empty=True, device_render=True,
                            emit_mips=2, mip_blur=0.75)
    for t in fused:
        assert isinstance(t, tuple) and len(t) == 3
        m0, m1, m2 = t
        assert m0.shape == (512, 512) and m1.shape == (256, 256) \
            and m2.shape == (128, 128)
        ref = cv2.resize(cv2.GaussianBlur(m0.astype(np.float32), (0, 0),
                                          0.75),
                         (256, 256), interpolation=cv2.INTER_AREA)
        ref = np.clip(np.rint(ref), 0, 255).astype(np.uint8)
        d = np.abs(ref[4:-4, 4:-4].astype(int) - m1[4:-4, 4:-4].astype(int))
        assert d.max() <= 1, d.max()


def test_render_whole_mesh_fused_mip_dirs(workdir, tmp_path):
    """render_whole_mesh(mip_dirs=...) writes mip tile dirs + metadata so
    the downsample stage skips those levels (fused render->mip pipeline);
    host and device routes produce the same level-1 mosaic."""
    from feabas_tpu.renderer import render_whole_mesh
    from feabas_tpu.dal import StreamLoader, StaticImageLoader
    from feabas_tpu.common import imread
    import os
    m = _smooth_mesh(N=512, mesh_size=128)
    loader = StreamLoader(_world())
    outs = {}
    for route, flag in (('dev', True), ('host', False)):
        d0 = tmp_path / route / 'mip0'
        d1 = tmp_path / route / 'mip1'
        os.makedirs(d0); os.makedirs(d1)
        tiles = render_whole_mesh(m.copy(), loader, str(d0 / 's'),
                                  tile_size=(256, 256), device_render=flag,
                                  mip_dirs=[str(d1)])
        assert tiles
        meta = d1 / 'metadata.txt'
        assert meta.exists()
        rows = [l.split('\t') for l in meta.read_text().splitlines()
                if not l.startswith('{')]
        assert len(rows) == len(tiles)
        outs[route] = {r[0]: imread(str(d1 / r[0])) for r in rows}
        for r in rows:   # mip1 tiles are half-size
            assert outs[route][r[0]].shape == (128, 128)
    assert set(outs['dev']) == set(outs['host'])
    for k in outs['dev']:
        d = np.abs(outs['dev'][k].astype(int) - outs['host'][k].astype(int))
        assert np.mean(d > 1) < 5e-3, (k, d.max(), np.mean(d > 1))


def test_cells_kernel_matches_flat_exactly(workdir):
    """The cell-binned raster kernel is an EXACT rewrite of the flat
    O(T)-per-pixel loop (same formulas, same ascending-index tie-break):
    compare the two kernels directly on the same dense-mesh table,
    including a folded (geodesic) mesh where arbitration order matters."""
    import jax.numpy as jnp
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader
    from feabas_tpu.ops import render as R

    for fold in (False, True):
        if fold:
            m = _smooth_mesh(N=512, mesh_size=48, amp=40.0)  # folds sheets
        else:
            m = _smooth_mesh(N=512, mesh_size=48)
        loader = StreamLoader(_world())
        r = MeshRenderer.from_mesh(m, image_loader=loader)
        eng = r._get_device_engine()
        resident = eng._resident_source(loader, 0)
        tb = eng._tb
        x0, y0, x1, y1 = 0, 0, 512, 512
        sel = np.nonzero((tb[:, 0] < x1) & (tb[:, 2] > x0) &
                         (tb[:, 1] < y1) & (tb[:, 3] > y0) &
                         np.isfinite(eng._w))[0]
        assert sel.size > R._CELL_MIN_TRIS     # the regime cells target
        tab = eng._table_for_block(sel, (x0, y0), resident[1], eng._w)
        cand = eng._cells_for_block(sel, (x0, y0), 512, 512)
        tabs = jnp.asarray(tab[None])
        flat = R._raster_render_shared(
            resident[0], tabs, jnp.float32(0), 512, 512,
            eng._geodesic, 'u8', 0, 0.0)
        cells = R._raster_render_shared_cells(
            resident[0], tabs, jnp.asarray(cand[None]), jnp.float32(0),
            512, 512, eng._geodesic, 'u8', 0, 0.0)
        assert (np.asarray(flat) == np.asarray(cells)).all(), (
            'cells kernel diverges from flat', fold)


def test_cells_group_dispatch_mixed_table_sizes(workdir):
    """Group-batched cells dispatch (cap > 1) with blocks whose candidate
    tables differ in T and K: the group pads tables to one pow2 Tp and
    candidate rows to one Kp, with padding entries pointing at rows that
    must be inert for EVERY block. Compare against per-block (cap 1)
    device renders, which the exactness test above ties to the host."""
    from feabas_tpu.renderer import MeshRenderer
    from feabas_tpu.dal import StreamLoader

    # blocks hanging off the mesh edge carry far fewer triangles than
    # interior ones, so the group mixes table sizes (and pow2 K widths)
    m = _smooth_mesh(N=768, mesh_size=40)
    loader = StreamLoader(_world(N=1024))
    r = MeshRenderer.from_mesh(m, image_loader=loader)
    eng = r._get_device_engine()
    blocks = [(0, 0, 512, 512), (512, 0, 1024, 512),
              (0, 512, 512, 1024), (512, 512, 1024, 1024)]
    sizes = set()
    for b in blocks:
        tb = eng._tb
        sel = np.nonzero((tb[:, 0] < b[2]) & (tb[:, 2] > b[0]) &
                         (tb[:, 1] < b[3]) & (tb[:, 3] > b[1]) &
                         np.isfinite(eng._w))[0]
        from feabas_tpu.ops.render import _CELL_MIN_TRIS
        assert sel.size > _CELL_MIN_TRIS
        sizes.add(1 << int(sel.size).bit_length())
    assert len(sizes) > 1, 'fixture no longer mixes table sizes'
    grouped = eng.render_blocks(blocks, loader, 0, np.uint8, group_cap=4)
    single = eng.render_blocks(blocks, loader, 0, np.uint8, group_cap=1)
    for g, s in zip(grouped, single):
        assert (g is None) == (s is None)
        if g is not None:
            assert (g == s).all()
