"""Shared per-band render stages.

One source of truth for the heavy frame stages, used by three consumers:

* `pipeline.deferred.DeferredRenderPipeline` (single card, full frame =
  one band at y_offset 0),
* `parallel.frame_sharded` (each card renders its row band at y_offset
  band*band_h inside `shard_map`),
* `tools.profile` (times each stage in isolation).

This mirrors how the reference funnels every draw through one
`DeferredPipeline` pass list regardless of presentation target
(DeferredPipeline.cpp:22-44); keeping a single implementation here is what
keeps the sharded path from drifting from the single-card one as kernels
evolve.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import clustered, gbuffer, raster, raster_pallas, shading


def geometry(buffers, model_mats, normal_mats, instance_visible, view_proj,
             width: int, height: int):
    """Vertex transform + triangle setup + packed vertex attrs.

    Replicated on every card in the sharded path (cheap vs. pixel work).
    Mirrors gbuffer.hlsl:75-83 vertex stage + D3D fixed-function setup.
    """
    clip = raster.vertex_transform(
        buffers["positions"], buffers["vtx_instance"], model_mats, view_proj
    )
    nrm_ws = raster.transform_directions(
        buffers["normals"], buffers["vtx_instance"], normal_mats
    )
    tan_ws = raster.transform_directions(
        buffers["tangents"], buffers["vtx_instance"], normal_mats
    )
    tri_ok = buffers["tri_valid_pool"] & instance_visible[buffers["tri_instance"]]
    setup = raster.setup_triangles(clip, buffers["tris"], tri_ok, width, height)
    vattrs = gbuffer.pack_vertex_attrs(buffers["uvs"], nrm_ws, tan_ws)
    return setup, vattrs


def binning(setup, width: int, band_h: int, tile_h: int, tile_w: int,
            bin_cap: int, y_offset=0):
    tiles_y, tiles_x = band_h // tile_h, width // tile_w
    t = setup.aabb.shape[0]
    # large pools: two-level binning cuts the per-tile top_k sort volume by
    # ~T/cap1 (Sponza-class scenes would otherwise spend 100s of ms here)
    if t >= 16384 and tiles_y * tiles_x >= 64:
        return raster.bin_triangles_hier(
            setup, tiles_y, tiles_x, tile_h, tile_w, bin_cap,
            y_offset=y_offset, cap1=min(t, 8 * bin_cap),
        )
    return raster.bin_triangles(
        setup, tiles_y, tiles_x, tile_h, tile_w, bin_cap, y_offset=y_offset,
    )


def rasterize(setup, bins, width: int, band_h: int, tile_h: int, tile_w: int,
              use_pallas: bool, y_offset=0, pallas_interpret: bool = False):
    """(tri_id, depth) for the band: the Triton tile kernel on the GPU, the
    plain XLA raster otherwise (same arithmetic, same tie rule)."""
    if use_pallas:
        return raster_pallas.rasterize_pallas(
            setup, bins, width, band_h, tile_h, tile_w, y_offset=y_offset,
            interpret=pallas_interpret,
        )
    return raster.rasterize(
        setup, bins, width, band_h, tile_h, tile_w, y_offset=y_offset
    )


def pack_rows64(setup, buffers, vattrs):
    """The (T, 64) per-triangle row pixel shading reads behind one index:
    [raster row 16 (raster.pack_raster_rows) | ConstantBufferInstance
    material 16 | vertex attr rows 24 | pad 8]. Columns 0:9 are the edge
    rows gbuffer._bary reads."""
    t = setup.edges.shape[0]
    return jnp.concatenate(
        [raster.pack_raster_rows(setup),
         buffers["mat_rows"][buffers["tri_material"]],
         vattrs[buffers["tris"]].reshape(t, 24),
         jnp.zeros((t, 8), jnp.float32)], axis=1,
    )


def gbuffer_shade(tri_id, depth, setup, buffers, vattrs, width: int,
                  band_h: int, texture_filter: str,
                  y_offset=0) -> gbuffer.GBuffer:
    # one 256 B row per triangle carrying EVERYTHING pixel shading needs
    # (edge/bary coefficients, material constants, the 3 vertex attribute
    # rows): the per-pixel stage fetches the winning triangle's row by index
    # once instead of four gathers (row + tris + 3 vertex rows)
    tri_rows = pack_rows64(setup, buffers, vattrs)
    return gbuffer.gbuffer_shade(
        tri_id, depth, tri_rows, buffers["atlas"],
        width, band_h, y_offset=y_offset, texture_filter=texture_filter,
    )


def active_lights(buffers, light_valid, view, max_active: int):
    return clustered.build_active_lights(
        buffers["light_pos"], buffers["light_color"],
        buffers["light_intensity"], buffers["light_attenuation"],
        light_valid, view, max_active,
    )


def deferred_shade(gb: gbuffer.GBuffer, buffers, active, inv_view, camera_pos,
                   config, width: int, band_h: int, y_offset=0,
                   full_height: int | None = None,
                   full_width: int | None = None,
                   light_tile: tuple | None = None,
                   light_cap: int = 256,
                   pallas_interpret: bool = False):
    return shading.deferred_shade(
        gb.albedo_emission, gb.normal_oct, gb.rough_metal_ao, gb.depth,
        gb.mask, buffers["SkyBoxSH"], buffers["PrecomputeBRDF"],
        buffers["PrefilterEnvMap"], buffers["SkyBoxTexture"],
        active, inv_view, camera_pos,
        config.fov, config.ratio, config.near, config.far,
        width, band_h, y_offset=y_offset, full_height=full_height,
        full_width=full_width, light_tile=light_tile, light_cap=light_cap,
        interpret=pallas_interpret,
    )


def light_tile_overflow(active, config, width: int, band_h: int,
                        light_tile: tuple | None, light_cap: int,
                        full_width: int, full_height: int, y_offset=0):
    """Most lights any tile's culled list drops at `light_cap` (0 without
    the tile kernel); XLA shares the cull with the kernel's own."""
    if light_tile is None:
        return jnp.zeros((), jnp.int32)
    th, tw = light_tile
    _, counts = clustered.tile_light_lists(
        active, band_h // th, width // tw, th, tw, full_width, full_height,
        config.fov, config.ratio, config.near, config.far, light_cap,
        y_offset=y_offset,
    )
    return jnp.maximum(counts - light_cap, 0).max()
