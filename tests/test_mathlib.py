import numpy as np
import pytest

from direct12pbrrenderer.utils import mathlib as ml


def test_projection_matrix1_depth_range():
    """ndc z must be 0 at near and 1 at far (MathLib.cpp:35-68 convention)."""
    p = ml.projection_matrix1(0.333 * np.pi, 1.5, 0.1, 1000.0)
    for z, expected in ((0.1, 0.0), (1000.0, 1.0)):
        v = p @ np.array([0, 0, z, 1], np.float32)
        assert v[2] / v[3] == pytest.approx(expected, abs=1e-5)
    # w after projection is view z
    v = p @ np.array([0.3, -0.2, 42.0, 1], np.float32)
    assert v[3] == pytest.approx(42.0)


def test_projection_matrix0_depth_range():
    p = ml.projection_matrix0(1.0, 1.0, 1.0, 100.0)
    near = p @ np.array([0, 0, 1.0, 1], np.float32)
    far = p @ np.array([0, 0, 100.0, 1], np.float32)
    assert near[2] / near[3] == pytest.approx(-1.0, abs=1e-5)
    assert far[2] / far[3] == pytest.approx(1.0, abs=1e-5)


def test_quick_inverse_matches_numpy():
    m = ml.compose_trs([1, 2, 3], [30, 60, -15], [2.0, 0.5, 1.5])
    inv = ml.quick_inverse(m)
    np.testing.assert_allclose(inv @ m, np.eye(4), atol=1e-5)


def test_compose_trs_translation_column():
    """Column-vector convention: translation in the last column."""
    m = ml.compose_trs([5, 6, 7], [0, 0, 0], [1, 1, 1])
    np.testing.assert_allclose(m[:3, 3], [5, 6, 7])
    np.testing.assert_allclose(ml.transform_point(m, [0, 0, 0]), [5, 6, 7])


def test_camera_yaw_pi_faces_negative_z():
    """App.cpp:99-101: camera at (0,3,10) rotated (0, pi, 0) looks down -z."""
    from direct12pbrrenderer.scene.camera import Camera

    cam = Camera(0.333 * np.pi, 1440, 960, 0.1, 1000.0)
    cam.move([0, 3, 10])
    cam.rotate(0, np.pi, 0)
    fwd = ml.transform_vector(cam.world_matrix(), [0, 0, 1])
    np.testing.assert_allclose(fwd, [0, 0, -1], atol=1e-6)
    # a point in front of the camera projects to ndc center with z in (0,1)
    p = cam.view_proj() @ np.array([0, 3, 0, 1], np.float32)
    ndc = p[:3] / p[3]
    assert abs(ndc[0]) < 1e-5 and abs(ndc[1]) < 1e-5 and 0 < ndc[2] < 1


def test_octahedral_roundtrip():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = ml.encode_octahedron(d)
    assert uv.min() >= 0 and uv.max() <= 1
    back = ml.decode_octahedron(uv)
    assert np.abs((back * d).sum(-1) - 1).max() < 1e-5


def test_octahedral_8bit_quantized_error_small():
    """G-buffer stores octahedral normals at 8 bits/channel (RGBA8 quirk)."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    q = np.round(ml.encode_octahedron(d) * 255) / 255
    back = ml.decode_octahedron(q.astype(np.float32))
    assert np.degrees(np.arccos(np.clip((back * d).sum(-1), -1, 1))).max() < 1.0


def test_cubemap_roundtrip():
    for face in range(6):
        for u, v in [(0.3, 0.7), (0.9, 0.1), (0.5, 0.5)]:
            d = ml.cubemap_direction(face, u, v)
            f2, u2, v2 = ml.cubemap_coordinate(d)
            assert f2 == face
            assert u2 == pytest.approx(u, abs=1e-5)
            assert v2 == pytest.approx(v, abs=1e-5)


def test_frustum_cull():
    vp = ml.projection_matrix1(1.0, 1.0, 0.1, 100.0)  # camera at origin, +z
    planes = ml.frustum_planes_from_matrix(vp)
    mins = np.array([[-1, -1, 9], [-1, -1, -20], [-1, -1, 150]], np.float32)
    maxs = mins + 2
    mask = ml.frustum_cull_aabbs(planes, mins, maxs)
    assert mask.tolist() == [True, False, False]
