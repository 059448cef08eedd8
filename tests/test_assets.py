"""Asset pipeline parity tests against the shipped reference asset tree."""

import json

import numpy as np
import pytest

from direct12pbrrenderer.resource import reflection_def  # noqa: F401
from direct12pbrrenderer.resource.bc import (
    bc1_decode_mip,
    bc1_encode_mip,
    bc6h_decode_mip,
    bc6h_encode_mip,
)
from direct12pbrrenderer.resource.formats import ETextureFormat
from direct12pbrrenderer.resource.resources import (
    MaterialResource,
    ModelResource,
    TextureResource,
)
from direct12pbrrenderer.resource.serialization import (
    Reader,
    binary_deserialize,
    binary_serialize,
    json_deserialize,
    json_serialize,
)
from direct12pbrrenderer.resource.storage import (
    EVertexFormat,
    MeshData,
    TextureData,
)
from direct12pbrrenderer.scene.scene import Scene


def test_barrel_mesh_binary(asset_loader):
    mesh = asset_loader.load_binary(MeshData, "Asset/Model/Barrel/Barrel_Mesh_data")
    assert mesh.vertex_format == EVertexFormat.P3F_N3F_T3F_C3F_T2F
    assert mesh.vertex_count == 2868
    assert mesh.index_count == 2868
    assert len(mesh.sub_meshes) == 1
    assert mesh.sub_meshes[0].indices_count == 2868
    v = mesh.vertex_array()
    # AABB stored in the file must match the actual vertex extents
    np.testing.assert_allclose(v["position"].min(0), mesh.bound_min, atol=1e-6)
    np.testing.assert_allclose(v["position"].max(0), mesh.bound_max, atol=1e-6)
    # normals are unit
    np.testing.assert_allclose(np.linalg.norm(v["normal"], axis=1), 1.0, atol=1e-3)


def test_mesh_binary_roundtrip(asset_loader):
    raw = (asset_loader.asset_root / "Asset/Model/Barrel/Barrel_Mesh_data.bin").read_bytes()
    mesh = binary_deserialize(MeshData, Reader(raw))
    out = bytearray()
    binary_serialize(mesh, out)
    assert bytes(out) == raw


def test_barrel_texture_bc1_decode(asset_loader):
    tex = asset_loader.load_binary(TextureData, "Asset/Model/Barrel/Barrel_barrel_color_data")
    assert tex.format == ETextureFormat.B8G8R8A8_UNORM_SRGB
    assert (tex.width, tex.height) == (1024, 1024)
    assert tex.mip_levels == 11
    m0 = tex.mip_array_rgba(0)
    assert m0.shape == (1024, 1024, 4)
    assert m0[..., 3].min() == 255  # opaque
    # decoded content is non-trivial
    assert m0[..., :3].std() > 5
    # mip consistency: mip1 mean close to mip0 mean
    m1 = tex.mip_array_rgba(1).astype(np.float32)
    assert abs(m1[..., :3].mean() - m0[..., :3].astype(np.float32).mean()) < 2.0


def test_bc1_roundtrip_exactish():
    rng = np.random.default_rng(0)
    # piecewise-constant blocks compress losslessly-ish under BC1
    img = np.repeat(np.repeat(rng.integers(0, 255, (4, 4, 4), np.uint8), 4, 0), 4, 1)
    img[..., 3] = 255
    dec = bc1_decode_mip(bc1_encode_mip(img), 16, 16)
    err = np.abs(dec[..., :3].astype(int) - img[..., :3].astype(int))
    assert err.max() <= 8  # 565 quantization only


def test_bc6h_mode11_roundtrip():
    # smooth HDR-like gradient (the realistic content for BC6H env maps)
    y, x = np.mgrid[0:16, 0:16].astype(np.float32) / 16.0
    img = np.stack([2 + 6 * x, 1 + 3 * y, 0.5 + 2 * x * y, np.ones_like(x)], -1).astype(
        np.float16
    )
    blob = bc6h_encode_mip(img)
    assert len(blob) == 16 * 16
    dec = bc6h_decode_mip(blob, 16, 16).astype(np.float32)
    ref = img.astype(np.float32)
    rel = np.abs(dec[..., :3] - ref[..., :3]) / (ref[..., :3] + 0.1)
    assert np.median(rel) < 0.05
    assert rel.max() < 0.5  # single shared index across channels bounds worst-case


def test_bc6h_high_quality_two_region_encode():
    """quality="high" runs the 32-partition mode-0 search: on edge content
    (two distinct HDR populations per block) it must beat mode 11, decode
    bit-consistently through BOTH decoders, and actually emit mode-0 blocks."""
    from direct12pbrrenderer.resource import bc

    rng = np.random.default_rng(7)
    # hard two-population content: bright sky vs dark ground with a ragged
    # boundary through every block — the worst case for single-region encode
    img = np.empty((16, 16, 4), np.float32)
    boundary = 8 + (rng.integers(-5, 6, size=16))
    for col in range(16):
        img[: boundary[col], col, :3] = [22.0, 17.0, 9.0] + rng.normal(
            0, 0.2, (boundary[col], 3)
        )
        img[boundary[col] :, col, :3] = [0.05, 0.08, 0.03] + rng.normal(
            0, 0.005, (16 - boundary[col], 3)
        )
    img[..., 3] = 1.0
    img = np.maximum(img, 0).astype(np.float16)

    blob_fast = bc6h_encode_mip(img, quality="fast")
    blob_high = bc6h_encode_mip(img, quality="high")
    assert len(blob_high) == len(blob_fast) == 16 * 16

    ref = img[..., :3].astype(np.float32)

    def mse(blob):
        dec = bc6h_decode_mip(blob, 16, 16).astype(np.float32)[..., :3]
        return float(((dec - ref) ** 2).mean())

    # 2-region wins on edges (>=1.2 dB here; the residual is boundary shapes
    # the 32 fixed BPTC partition patterns cannot represent)
    assert mse(blob_high) < 0.75 * mse(blob_fast)

    # at least one block chose mode 0 (first two stored bits == 00)
    raw = np.frombuffer(blob_high, np.uint8).reshape(-1, 16)
    assert ((raw[:, 0] & 0x3) == 0).any()

    # python decoder and the C++ codec agree on the mode-0 blocks
    from direct12pbrrenderer.resource import native_codec

    if native_codec.available():
        dec_native = native_codec.bc6h_decode_mip(blob_high, 16, 16)
        dec_py = np.stack(
            [bc._decode_bc6h_block(b) for b in raw]
        ).reshape(4, 4, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(16, 16, 3)
        assert np.array_equal(
            dec_native[..., :3].astype(np.float32), dec_py.astype(np.float32)
        )


def test_texture_binary_roundtrip_through_bc1():
    """Our serializer writes TextureInfo + BC1 payload that we can re-read."""
    rng = np.random.default_rng(2)
    img = np.repeat(np.repeat(rng.integers(0, 255, (8, 8, 4), np.uint8), 4, 0), 4, 1)
    img[..., 3] = 255
    tex = TextureData.from_mips([img], ETextureFormat.R8G8B8A8_UNORM)
    out = bytearray()
    binary_serialize(tex, out)
    tex2 = binary_deserialize(TextureData, Reader(bytes(out)))
    assert (tex2.width, tex2.height, tex2.mip_levels) == (32, 32, 1)
    err = np.abs(
        tex2.mip_array(0)[..., :3].astype(int) - tex.mip_array(0)[..., :3].astype(int)
    )
    assert err.max() <= 8


def test_scene_json_loads(asset_loader):
    scene = asset_loader.load_resource(Scene, "Asset/Scene/main.json")
    assert len(scene.models) == 38
    assert len(scene.lights) == 8
    assert scene.skybox_path == "Asset/SkyBox/HDRWild"
    # first light from main.json
    l0 = scene.lights[0]
    assert l0.name == "light_1"
    np.testing.assert_allclose(l0.translation, [-4.2, 1.0, 3.5])
    np.testing.assert_allclose(l0.color, [0.9, 0.1, 0.3])
    assert l0.intensity == 10.0 and l0.radius == 2.0
    # attenuation: radius 2.0 -> preset {7, 1, 0.7, 1.8} (lower-bound rule)
    np.testing.assert_allclose(l0.attenuation, [2.0, 1.0, 0.7, 1.8])
    # every model with shipped binaries resolved its mesh + materials; the
    # reference tree is missing the Revolver mesh blob
    loaded = [sm for sm in scene.models if sm.model is not None]
    assert len(loaded) == 37
    for sm in loaded:
        assert sm.model.mesh_resource.mesh.vertex_count > 0
        for mat in sm.model.materials:
            assert mat.shader_path == "gbuffer.hlsl"


def test_scene_json_roundtrip(asset_loader):
    scene = asset_loader.load_resource(Scene, "Asset/Scene/main.json")
    data = json_serialize(scene)
    original = json.loads((asset_loader.asset_root / "Asset/Scene/main.json").read_text())
    # field-level equality for every object (modulo float formatting)
    assert data["mSkyBoxPath"] == original["mSkyBoxPath"]
    assert len(data["mSceneModel"]) == len(original["mSceneModel"])
    for ours, ref in zip(data["mSceneLight"], original["mSceneLight"]):
        assert ours["@SceneObject"]["mName"] == ref["@SceneObject"]["mName"]
        for k in ("x", "y", "z"):
            assert ours["@SceneObject"]["mTranslation"][k] == pytest.approx(
                ref["@SceneObject"]["mTranslation"][k]
            )
        assert ours["mIntensity"] == pytest.approx(ref["mIntensity"])


def test_material_parameter_table(asset_loader):
    mat = asset_loader.load_resource(MaterialResource, "Asset/Model/Barrel/Barrel_Mat_0")
    assert mat.get_parameter("UseAlbedoMap") is True
    assert set(mat.textures) == {
        "AlbedoMap", "NormalMap", "RoughnessMap", "MetallicMap", "AmbientOcclusionMap",
    }
    for t in mat.textures.values():
        assert t.texture.width > 0


def test_model_cached_identity(asset_loader):
    m1 = asset_loader.load_resource(ModelResource, "Asset/Model/Barrel/Barrel_Model")
    m2 = asset_loader.load_resource(ModelResource, "Asset/Model/Barrel/Barrel_Model")
    assert m1 is m2


def test_bc6h_all_modes_against_reference_vectors():
    """All 14 BC6H modes (plus the 4 reserved modes -> black) against
    decode vectors produced by Mesa's BPTC decoder (the GL reference
    implementation of the same D3D11 spec DirectXTex implements).
    Vectors: tests/data/bc6h_vectors.npz (random blocks, every mode)."""
    import pathlib

    from direct12pbrrenderer.resource import bc

    data = np.load(pathlib.Path(__file__).parent / "data" / "bc6h_vectors.npz")
    blocks, want = data["blocks"], data["texels"]
    got = np.stack([bc._decode_bc6h_block(b) for b in blocks])
    np.testing.assert_array_equal(got, want)

    # the ctypes native codec must agree bit-for-bit (blocks laid out as a
    # (4, 4N) mip)
    from direct12pbrrenderer.resource import native_codec

    if native_codec.available():
        n = len(blocks)
        dec = native_codec.bc6h_decode_mip(
            blocks.tobytes(), 4 * n, 4
        ).astype(np.float32)
        got_native = np.stack(
            [dec[:, i * 4 : (i + 1) * 4, :3] for i in range(n)]
        )
        np.testing.assert_array_equal(got_native, want)
