"""End-to-end importer tests: OBJ/MTL/PNG -> resources -> rendered frame,
plus the console commands (the reference's Command.txt workflow)."""

import numpy as np
import pytest

from direct12pbrrenderer.app import console
from direct12pbrrenderer.resource import reflection_def  # noqa: F401
from direct12pbrrenderer.resource.loader import ResourceLoader
from direct12pbrrenderer.resource.resources import CubeMapResource, ModelResource
from direct12pbrrenderer.resource.storage import CubeMapTextureData


@pytest.fixture
def workspace(tmp_path):
    loader = ResourceLoader(tmp_path)
    old = ResourceLoader._instance
    ResourceLoader.set_instance(loader)
    yield tmp_path, loader
    ResourceLoader._instance = old


def _write_quad_obj(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    tex = rng.integers(0, 255, (16, 16, 3), np.uint8)
    Image.fromarray(tex).save(root / "checker.png")
    (root / "quad.mtl").write_text(
        "newmtl quadmat\nmap_Kd checker.png\nmap_Pr checker.png\n"
    )
    (root / "quad.obj").write_text(
        "mtllib quad.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vn 0 0 -1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl quadmat\n"
        # wound to be front-facing (CW in y-down screen) from the -z side
        "f 4/4/1 3/3/1 2/2/1 1/1/1\n"  # quad -> fan-triangulated
    )


def test_import_model_roundtrip(workspace):
    root, loader = workspace
    _write_quad_obj(root)
    model = loader.import_model(root / "quad.obj", "Asset/Quad/Quad", scale=2.0)
    assert model is not None
    # dumped resources re-load from disk through a FRESH loader
    loader2 = ResourceLoader.set_instance(ResourceLoader(root))
    m2 = loader2.load_resource(ModelResource, "Asset/Quad/Quad_Model")
    mesh = m2.mesh_resource.mesh
    assert mesh.index_count == 6  # quad fan -> 2 triangles
    v = mesh.vertex_array()
    # recentered (centroid at origin) and scaled by 2
    np.testing.assert_allclose(v["position"].mean(0), 0, atol=1e-6)
    assert v["position"][:, 0].max() == pytest.approx(2.0)
    # tangents computed (unit, not the degenerate fallback everywhere)
    np.testing.assert_allclose(np.linalg.norm(v["tangent"], axis=1), 1, atol=1e-5)
    # material picked up both maps from the .mtl
    mat = m2.materials[0]
    assert mat.get_parameter("UseAlbedoMap") is True
    assert mat.get_parameter("UseRoughnessMap") is True
    assert mat.textures["AlbedoMap"].texture.width == 16


def test_imported_model_renders(workspace):
    root, loader = workspace
    _write_quad_obj(root)
    loader.import_model(root / "quad.obj", "Asset/Quad/Quad")

    from direct12pbrrenderer.config import RenderConfig
    from direct12pbrrenderer.pipeline.deferred import DeferredRenderPipeline
    from direct12pbrrenderer.scene.camera import Camera
    from direct12pbrrenderer.scene.scene import Scene, SceneLight, SceneModel

    scene = Scene("mem/scene")
    sm = SceneModel("quad")
    sm.set_model(loader.load_resource(ModelResource, "Asset/Quad/Quad_Model"))
    sm.update_transform()
    scene.add_model(sm)
    # quad normal is (0,0,-1): camera + light on the -z side see its front
    light = SceneLight("key")
    light.translation = np.array([0.5, 0.5, -2.0], np.float32)
    light.update_transform()
    light.set_intensity(30.0)
    scene.add_light(light)

    cfg = RenderConfig(width=128, height=96, max_triangles=64, max_vertices=64,
                       max_instances=2, max_lights=4)
    pipe = DeferredRenderPipeline(scene, cfg, tile_h=12, tile_w=64, bin_cap=128,
                                  prefilter_size=16, brdf_lut_size=32)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, -3])  # default orientation looks down +z
    img = np.asarray(pipe.render(cam))
    assert img[40:60, 50:80].mean() > 3  # textured quad lit in view


def test_console_sphere_and_sky_and_irradiance(workspace, tmp_path):
    root, loader = workspace
    console.main(["--asset-root", str(root), "CreateSphereModel", "-o", "Asset/Sphere"])
    m = ResourceLoader.instance().load_resource(ModelResource, "Asset/Sphere/sphere_Model")
    assert m.mesh_resource.mesh.vertex_count > 700

    console.main(["--asset-root", str(root), "CreateProceduralSky",
                  "-o", "Asset/Sky/Test", "-s", "32"])
    sky = ResourceLoader.instance().load_resource(CubeMapResource, "Asset/Sky/Test")
    assert sky.cubemap.size == 32
    assert np.abs(sky.sh.as_array()).sum() > 0  # SH baked

    out = tmp_path / "irr"
    console.main(["--asset-root", str(root), "GenerateIrradianceMap",
                  "-i", "Asset/Sky/Test", "-o", str(out), "-s", "16"])
    from direct12pbrrenderer.resource.hdr import load_hdr

    face = load_hdr(out / "py.hdr")
    assert face.shape == (16, 16, 3)
    # upper hemisphere irradiance of a sky-lit env is brighter than ground's
    nyface = load_hdr(out / "ny.hdr")
    assert face.mean() > nyface.mean()


def test_import_cubemap_from_hdr_faces(workspace):
    root, loader = workspace
    from direct12pbrrenderer.resource.hdr import save_hdr

    d = root / "cube"
    d.mkdir()
    g = np.linspace(0.2, 4.0, 16, dtype=np.float32)
    face_img = np.stack(
        [np.tile(g, (16, 1)), np.tile(g[:, None], (1, 16)), np.full((16, 16), 1.5)],
        axis=-1,
    ).astype(np.float32)
    for name in ("px", "nx", "py", "ny", "pz", "nz"):
        save_hdr(d / f"{name}.hdr", face_img)
    res = loader.import_cubemap(d, "Asset/Sky/FromHdr")
    assert res.cubemap.faces[0].format.name.startswith("R32G32B32A32")
    # reload from the BC6H-compressed .bin
    loader2 = ResourceLoader.set_instance(ResourceLoader(root))
    r2 = loader2.load_resource(CubeMapResource, "Asset/Sky/FromHdr")
    a = res.cubemap.face_arrays(0)[..., :3].astype(np.float32)
    b = r2.cubemap.face_arrays(0)[..., :3].astype(np.float32)
    # BC6H mode-11 roundtrip: moderate relative error on smooth-ish content
    assert np.median(np.abs(a - b) / (np.abs(a) + 0.1)) < 0.2
