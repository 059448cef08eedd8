"""The Triton tile raster kernel (ops/raster_pallas) against the plain XLA
raster (ops/raster.rasterize): Pallas interpret mode on the CPU, the compiled
kernel on the card (`gpu` marker)."""

import numpy as np
import jax.numpy as jnp
import pytest

from direct12pbrrenderer.ops import gbuffer, raster, raster_pallas

W, H, TILE_H, TILE_W = 256, 192, 16, 64


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    # random small triangles across ndc, CW-in-screen enforced by validity
    c = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    d = rng.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    v = np.concatenate([c, c + d], axis=1)  # (n, 3, 3)
    v[..., 2] = rng.uniform(0.05, 0.95, (n, 3))
    verts = v.reshape(-1, 3)
    w = np.ones((len(verts), 1), np.float32)
    clip = np.concatenate([verts * w, w], axis=1).astype(np.float32)
    tris = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    return jnp.asarray(clip), jnp.asarray(tris)


def _bin(clip, tris, cap, w=W, h=H):
    setup = raster.setup_triangles(clip, tris, jnp.ones(tris.shape[0], bool),
                                   w, h)
    bins = raster.bin_triangles(setup, h // TILE_H, w // TILE_W, TILE_H,
                                TILE_W, cap)
    return setup, bins


def _both(setup, bins, w=W, h=H, interpret=True):
    ref = raster.rasterize(setup, bins, w, h, TILE_H, TILE_W)
    got = raster_pallas.rasterize_pallas(setup, bins, w, h, TILE_H, TILE_W,
                                         interpret=interpret)
    return [np.asarray(x) for x in ref], [np.asarray(x) for x in got]


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_matches_xla(seed):
    (ids_ref, z_ref), (ids_pl, z_pl) = _both(*_bin(*_scene(300, seed), 128))
    # the two share candidate_depth/depth_fold, so only the compiler's FMA
    # contraction could flip a pixel centre lying exactly on an edge
    mismatch = ids_pl != ids_ref
    assert mismatch.mean() < 1e-4, f"{mismatch.sum()} id mismatches"
    agree = ~mismatch
    np.testing.assert_allclose(z_pl[agree], z_ref[agree], atol=1e-6)
    assert (ids_ref >= 0).mean() > 0.2


def test_pallas_dynamic_count_correct():
    """Bins mostly empty (empty tiles): the per-tile trip count must not skip
    real work nor paint empty tiles."""
    setup, bins = _bin(*_scene(5), 256)
    counts = np.asarray(bins.counts)
    assert (counts == 0).any() and (counts > 0).any()
    (ids_ref, z_ref), (ids_pl, z_pl) = _both(setup, bins)
    np.testing.assert_array_equal(ids_pl, ids_ref)
    np.testing.assert_array_equal(z_pl, z_ref)
    assert (ids_pl >= 0).sum() > 0


def _rows64(setup, seed=0):
    """Synthetic material + vertex-attr rows (the stages.pack_rows64 layout)."""
    rng = np.random.default_rng(seed + 100)
    t = setup.edges.shape[0]
    mat = jnp.asarray(rng.uniform(0, 1, (t, 16)).astype(np.float32))
    vat = jnp.asarray(rng.uniform(-1, 1, (t, 24)).astype(np.float32))
    return jnp.concatenate(
        [raster.pack_raster_rows(setup), mat, vat,
         jnp.zeros((t, 8), jnp.float32)], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_interp_matches_gather_path(seed):
    """Kernel ids + interp_from_rows (the winning row fetched by index) must
    equal the XLA raster + the same gather wherever the ids agree, and zero
    the background."""
    setup, bins = _bin(*_scene(300, seed), 128)
    rows64 = _rows64(setup, seed)
    (ids_ref, _), (ids_pl, _) = _both(setup, bins)
    interp_ref, mat_ref, _ = gbuffer.interp_from_rows(
        jnp.asarray(ids_ref), rows64, W, H)
    interp_pl, mat_pl, mask = gbuffer.interp_from_rows(
        jnp.asarray(ids_pl), rows64, W, H)
    agree = (ids_pl == ids_ref) & (ids_ref >= 0)
    assert agree.mean() > 0.2
    np.testing.assert_array_equal(np.asarray(interp_pl)[agree],
                                  np.asarray(interp_ref)[agree])
    np.testing.assert_array_equal(np.asarray(mat_pl)[agree],
                                  np.asarray(mat_ref)[agree])
    assert not np.asarray(mask)[ids_pl < 0].any()


def test_full_bin_and_overflow_truncate_alike():
    """A tile whose list is exactly full, and one past its capacity: both
    rasters walk the same first `cap` ids (draw order) and agree."""
    clip, tris = _scene(400, 5)
    for cap in (8, 16):
        setup, bins = _bin(clip, tris, cap)
        counts = np.asarray(bins.counts)
        assert (counts >= cap).any()
        (ids_ref, z_ref), (ids_pl, z_pl) = _both(setup, bins)
        np.testing.assert_array_equal(ids_pl, ids_ref)
        np.testing.assert_array_equal(z_pl, z_ref)


def _quad_pair(z0, z1):
    """Two full-screen-ish triangles of the same footprint at clip z0 / z1
    (w = 1), ids 0 and 1."""
    base = np.array([[-0.9, -0.9], [-0.9, 0.9], [0.9, -0.9]], np.float32)
    v = []
    for z in (z0, z1):
        v += [[x, y, z, 1.0] for x, y in base]
    return (jnp.asarray(np.array(v, np.float32)),
            jnp.asarray(np.arange(6, dtype=np.int32).reshape(2, 3)))


@pytest.mark.parametrize("reverse_bins", [False, True])
def test_depth_ties_resolve_to_lowest_id(reverse_bins):
    """Coplanar duplicates: the lowest triangle id wins in both rasters,
    whatever order the bin lists hold them in."""
    setup, bins = _bin(*_quad_pair(0.5, 0.5), 8)
    if reverse_bins:
        ids = np.array(bins.ids)
        n = np.asarray(bins.counts)
        for t in range(ids.shape[0]):
            ids[t, :n[t]] = ids[t, :n[t]][::-1]
        bins = raster.Bins(jnp.asarray(ids), bins.counts)
    (ids_ref, _), (ids_pl, _) = _both(setup, bins)
    covered = ids_ref >= 0
    assert covered.mean() > 0.2
    assert (ids_ref[covered] == 0).all() and (ids_pl[covered] == 0).all()
    np.testing.assert_array_equal(ids_pl, ids_ref)


def test_nearer_triangle_wins_over_lower_id():
    setup, bins = _bin(*_quad_pair(0.6, 0.3), 8)
    (ids_ref, _), (ids_pl, _) = _both(setup, bins)
    covered = ids_ref >= 0
    assert (ids_ref[covered] == 1).all() and (ids_pl[covered] == 1).all()


def test_near_plane_crossing_triangle():
    """A triangle with one vertex behind the camera (clipless homogeneous
    setup): the kernel reproduces the XLA raster's visible wedge."""
    clip = jnp.asarray(np.array([
        [-0.5, -0.5, 0.5, 1.0],
        [0.5, -0.5, 0.5, 1.0],
        [0.0, 0.8, -0.5, -0.3],    # w < 0: behind the camera
        [-0.8, 0.2, 0.3, 1.0],
        [-0.2, 0.6, 0.3, 1.0],
        [-0.8, 0.7, 0.3, 1.0],
    ], np.float32))
    tris = jnp.asarray(np.array([[0, 2, 1], [3, 5, 4]], np.int32))
    setup = raster.setup_triangles(clip, tris, jnp.ones(2, bool), W, H)
    bins = raster.bin_triangles(setup, H // TILE_H, W // TILE_W, TILE_H,
                                TILE_W, 8)
    (ids_ref, z_ref), (ids_pl, z_pl) = _both(setup, bins)
    np.testing.assert_array_equal(ids_pl, ids_ref)
    np.testing.assert_array_equal(z_pl, z_ref)


def test_wrapper_rejects_bad_shapes():
    setup, bins = _bin(*_scene(20), 128)
    with pytest.raises(ValueError, match="power of two"):
        raster_pallas.rasterize_pallas(setup, bins, W, H, 24, 64,
                                       interpret=True)
    bins_odd = raster.Bins(bins.ids[:, :12], bins.counts)
    with pytest.raises(ValueError, match="multiple"):
        raster_pallas.rasterize_pallas(setup, bins_odd, W, H, TILE_H, TILE_W,
                                       interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu_device):
    """The compiled Triton kernel on the card against the XLA raster."""
    setup, bins = _bin(*_scene(2000, 2), 512, w=1024, h=512)
    (ids_ref, z_ref), (ids_pl, z_pl) = _both(setup, bins, w=1024, h=512,
                                             interpret=False)
    mismatch = ids_pl != ids_ref
    assert mismatch.mean() <= 1e-4
    np.testing.assert_allclose(z_pl[~mismatch], z_ref[~mismatch], atol=1e-6)
