"""Tile-clustered point-light kernel (ops/lights_pallas) vs the fori path.

The reference sizes clustered shading for <=1024 lights / <=32 per cluster
(DeferredPipeline.h:326-330, clustered_culling.hlsl,
deferred_shading.hlsl:159-186). ops.shading's fori path pins those semantics;
these tests pin the Triton tile kernel against it (Pallas interpret mode on
the CPU, compiled on the card under the `gpu` marker) — same cluster
membership, same light index order, same cap-32 counter — at light counts
far above the reference scene's 8.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from direct12pbrrenderer.ops import common, shading

H, W = 48, 256
TILE = (16, 64)
FOV, NEAR, FAR = math.pi / 3.0, 0.1, 100.0
RATIO = W / H


def _gbuffer(rng):
    alb_em = jnp.asarray(rng.uniform(0.05, 1.0, (H, W, 4)), jnp.float32)
    oct_ = jnp.asarray(rng.uniform(-1.0, 1.0, (H, W, 2)), jnp.float32)
    rma = jnp.asarray(rng.uniform(0.05, 1.0, (H, W, 3)), jnp.float32)
    depth = jnp.asarray(rng.uniform(0.05, 0.95, (H, W)), jnp.float32)
    mask = jnp.asarray(rng.uniform(0, 1, (H, W)) > 0.1)
    return alb_em, oct_, rma, depth, mask


def _light_rows(rng, n, max_active, all_covering=False):
    """(max_active, 14) active rows, identity view (pos_view == pos_w)."""
    z = rng.uniform(1.0, 60.0, n)
    tan_half = math.tan(FOV / 2.0)
    x = rng.uniform(-1, 1, n) * z * tan_half * RATIO
    y = rng.uniform(-1, 1, n) * z * tan_half
    pos = np.stack([x, y, z], -1)
    color = rng.uniform(0.2, 1.0, (n, 3))
    inten = rng.uniform(1.0, 8.0, n)
    att = np.stack([np.ones(n), 0.1 * np.ones(n), 0.01 * np.ones(n)], -1)
    cull = (np.full(n, 500.0) if all_covering
            else rng.uniform(2.0, 15.0, n))
    rows = np.concatenate(
        [pos, color, inten[:, None], att, pos, cull[:, None]], axis=1
    ).astype(np.float32)
    return jnp.asarray(
        np.pad(rows, ((0, max_active - n), (0, 0)))
    )


def _shade(rows, gb, light_tile, light_cap=256, interpret=True):
    alb_em, oct_, rma, depth, mask = gb
    sh = jnp.zeros((7, 4), jnp.float32)
    lut = (common.make_quad_tex2d(jnp.zeros((8, 8, 2), jnp.float32)), 8)
    cube = common.CubeMipAtlas([np.zeros((6, 8, 8, 3), np.float32)])
    return shading.deferred_shade(
        alb_em, oct_, rma, depth, mask, sh, lut, cube, cube,
        rows, jnp.eye(4), jnp.zeros(3), FOV, RATIO, NEAR, FAR, W, H,
        light_tile=light_tile, light_cap=light_cap, interpret=interpret,
    )


@pytest.mark.parametrize("scenario", ["scattered", "capped"])
def test_tile_kernel_matches_fori(scenario):
    rng = np.random.default_rng(7 if scenario == "scattered" else 8)
    gb = _gbuffer(rng)
    if scenario == "scattered":
        # well above the reference scene's 8 lights; cap 256 >> any tile's
        # culled count so no tile truncation can mask a mismatch
        rows = _light_rows(rng, 130, 256)
    else:
        # 64 frustum-covering lights -> every pixel's cluster counter hits
        # the reference's 32-light cap; order-dependent truncation must agree
        rows = _light_rows(rng, 64, 128, all_covering=True)
    ref = np.asarray(_shade(rows, gb, None))
    got = np.asarray(_shade(rows, gb, TILE))
    # identical cluster membership / order / cap; residual diffs are pure
    # fp32 re-association (reciprocal-multiply vs divide normalization)
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


def test_tile_light_lists_counts():
    from direct12pbrrenderer.ops import clustered

    rng = np.random.default_rng(3)
    rows = _light_rows(rng, 40, 128)
    tiles_y, tiles_x = H // TILE[0], W // TILE[1]
    ids, counts = jax.jit(
        clustered.tile_light_lists,
        static_argnums=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
    )(rows, tiles_y, tiles_x, TILE[0], TILE[1], W, H, FOV, RATIO, NEAR, FAR,
      128)
    ids, counts = np.asarray(ids), np.asarray(counts)
    assert counts.shape == (tiles_y * tiles_x,)
    for t in range(counts.shape[0]):
        valid = ids[t][ids[t] >= 0]
        assert len(valid) == counts[t]
        # ascending id order == reference light order for cap semantics
        assert np.all(np.diff(valid) > 0)
    # every culled id is a real light; padded rows (cull_r=0) never listed
    assert ids.max() < 40


def test_pipeline_light_tile_path():
    """Full pipeline with 72 scattered lights: the tile-kernel frame must
    match the fori-path frame (uint8 within 1 LSB) and report no truncation."""
    from direct12pbrrenderer.config import RenderConfig
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera
    from direct12pbrrenderer.tools.stress_scene import build_stress_scene

    scene = build_stress_scene(cells_x=16, cells_y=8, n_lights=72)
    cfg = RenderConfig(width=256, height=96, max_instances=2, max_lights=128,
                       max_triangles=2048, max_vertices=2048)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 4, 10])
    cam.rotate(0, math.pi, 0.3)

    def run(**kw):
        pipe = DeferredRenderPipeline(
            scene, cfg, tile_h=TILE[0], tile_w=TILE[1], bin_cap=256,
            max_active_lights=128, atlas_max_dim=64, **kw,
        )
        img = np.asarray(pipe.render(cam))
        return img, pipe.last_stats, pipe.light_tile

    ref, _, no_tile = run(route="xla")
    got, stats, tile = run(pallas_interpret=True)
    assert no_tile is None and tile == TILE
    assert stats.lights_truncated == 0
    assert stats.light_tile_overflow == 0
    assert stats.visible_lights > 32
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_cluster_hit_table_matches_host_bounds():
    """The device hit table (fp32 closed-form AABBs) agrees with the host's
    float64 cluster_bounds sphere test away from exact-touch ties."""
    from direct12pbrrenderer.ops import clustered

    rng = np.random.default_rng(9)
    rows = _light_rows(rng, 64, 64)
    hits = np.asarray(clustered.cluster_light_hits(rows, FOV, RATIO, NEAR,
                                                   FAR))
    bounds = clustered.cluster_bounds(FOV, RATIO, NEAR, FAR).astype(np.float64)
    pv = np.asarray(rows)[:, 10:13].astype(np.float64)
    r = np.asarray(rows)[:, 13].astype(np.float64)
    d = pv[None] - np.clip(pv[None], bounds[:, None, 0], bounds[:, None, 1])
    d2 = (d * d).sum(-1)
    ref = d2 < r[None] ** 2
    clear = np.abs(d2 - r[None] ** 2) > 1e-3 * np.maximum(r[None] ** 2, 1.0)
    assert hits.shape == (clustered.NUM_CLUSTERS, 64)
    np.testing.assert_array_equal(hits[clear], ref[clear])
    assert hits.any() and not hits.all()


def test_overflowing_tile_lists_reported_and_cluster_cap_binds_first():
    """More lights than light_cap cover every tile: the overflow is reported,
    and since every cluster's 32-light cap fills from the first lights in
    index order, the kernel's truncated walk still equals the fori path."""
    from direct12pbrrenderer.config import RenderConfig
    from direct12pbrrenderer.pipeline import stages

    rng = np.random.default_rng(12)
    gb = _gbuffer(rng)
    rows = _light_rows(rng, 200, 256, all_covering=True)
    cfg = RenderConfig(width=W, height=H, fov=FOV, near=NEAR, far=FAR)
    over = int(stages.light_tile_overflow(rows, cfg, W, H, TILE, 128, W, H))
    assert over == 200 - 128
    assert int(stages.light_tile_overflow(rows, cfg, W, H, None, 128, W,
                                          H)) == 0
    ref = np.asarray(_shade(rows, gb, None))
    got = np.asarray(_shade(rows, gb, TILE, light_cap=128))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


def test_kernel_rejects_non_power_of_two_tile():
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="power of two"):
        _shade(_light_rows(rng, 8, 128), _gbuffer(rng), (24, 64))


@pytest.mark.gpu
def test_compiled_kernel_matches_fori(gpu_device):
    """Compiled kernel vs the XLA fori path over the cap-32 case. Roughness
    stays >= 0.3: below it the GGX denominator n.h^2 (a^2 - 1) + 1 cancels
    to ~a^2 at highlights, and XLA and Triton contract its multiply-add into
    FMAs differently, which no fp32 tolerance of this size absorbs."""
    rng = np.random.default_rng(8)
    alb_em, oct_, rma, depth, mask = _gbuffer(rng)
    rma = rma.at[..., 0].set(jnp.asarray(rng.uniform(0.3, 1.0, (H, W)),
                                         jnp.float32))
    gb = (alb_em, oct_, rma, depth, mask)
    rows = _light_rows(rng, 64, 128, all_covering=True)
    ref = np.asarray(_shade(rows, gb, None, interpret=False))
    got = np.asarray(_shade(rows, gb, TILE, interpret=False))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)
