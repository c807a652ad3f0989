"""Each module of the port's simulator (graspnerf_tpu_torch/sim/) against
the JAX package's (graspnerf_tpu/sim/) on the CPU, on seeds made with
numpy: quaternions and transforms, the primitives and their tracer, scene
generation, the domain-randomized renderer and its textures, meshes and
their descriptors, the gripper state machine, the TSDF acquisition, and the
experiment IO.

Both packages run the same numpy, so everything is held bit-equal unless
stated: the quaternion functions (numpy on both sides, in the same operation
order) and the TSDF fusion (torch against XLA: float32 rounding of the
projection and the average, within TSDF_ATOL = 1e-5, as
tests/test_torch_data.py holds it) carry tolerances. `same_tracer` gives
both packages one build of native/raytrace.cpp (or numpy for both), so that
scene generation and renders see the same rays; the tracer test also holds
the numpy intersects of both packages against each other.
"""
import os

import numpy as np
import pytest
import torch

import graspnerf_tpu.data.native as j_native
from graspnerf_tpu.ops import quat as JQ
from graspnerf_tpu.sim import io as JIO
from graspnerf_tpu.sim import mesh as JM
from graspnerf_tpu.sim import objects as JO
from graspnerf_tpu.sim import render as JR
from graspnerf_tpu.sim import simulation as JS
from graspnerf_tpu.sim import transform as JT
from graspnerf_tpu.sim.grasp import Grasp as JGrasp

import graspnerf_tpu_torch.data.native as t_native
from graspnerf_tpu_torch.data.synthetic import hemisphere_poses, intrinsics
from graspnerf_tpu_torch.ops import quat as TQ
from graspnerf_tpu_torch.sim import io as TIO
from graspnerf_tpu_torch.sim import mesh as TM
from graspnerf_tpu_torch.sim import objects as TO
from graspnerf_tpu_torch.sim import render as TR
from graspnerf_tpu_torch.sim import simulation as TS
from graspnerf_tpu_torch.sim import transform as TT
from graspnerf_tpu_torch.sim.grasp import (Grasp, Label, from_voxel_coordinates,
                                           to_voxel_coordinates)
from _torch_util import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUAT_ATOL = 1e-6
TSDF_ATOL = 1e-5


@pytest.fixture
def same_tracer(monkeypatch):
    """Both packages trace with the port's build of native/raytrace.cpp, or
    both with numpy where it cannot be built."""
    monkeypatch.setattr(j_native, "_lib", t_native._load())
    monkeypatch.setattr(j_native, "_tried", True)


@pytest.fixture
def numpy_tracers(monkeypatch):
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_tried", True)
    monkeypatch.setattr(t_native, "available", lambda: False)


def assert_objects_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.kind == b.kind and a.material == b.material
        assert a.name == b.name
        for k in ("params", "R", "t"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


def random_rotations(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ------------------------------------------------ quaternions, transforms
def test_quaternion_functions_match_jax(rng):
    q1, q2 = random_rotations(rng, 64), random_rotations(rng, 64)
    v = rng.randn(64, 3)
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, 64)
    m = JQ.quat_to_matrix(q1)
    pairs = [
        (TQ.normalize(q1 * 3), JQ.normalize(q1 * 3)),
        (TQ.quat_multiply(q1, q2), JQ.quat_multiply(q1, q2)),
        (TQ.quat_conjugate(q1), JQ.quat_conjugate(q1)),
        (TQ.quat_to_matrix_np(q1), m),
        (TQ.matrix_to_quat(m), JQ.matrix_to_quat(m)),
        (TQ.rotate_vector(q1, v), JQ.rotate_vector(q1, v)),
        (TQ.from_axis_angle(axis, angle), JQ.from_axis_angle(axis, angle)),
        # a single matrix, and the axes' rotations (each branch of Shepperd)
        (TQ.matrix_to_quat(m[0]), JQ.matrix_to_quat(m[0])),
        *((TQ.matrix_to_quat(r), JQ.matrix_to_quat(r))
          for r in np.diag([1.0, -1.0, -1.0])[None] * np.ones((1, 1, 1))),
    ]
    for got, want in pairs:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, want, rtol=0, atol=QUAT_ATOL)
    # the torch function the loss uses agrees with the numpy one
    np.testing.assert_allclose(
        TQ.quat_to_matrix(torch.from_numpy(q1)).numpy(), m, atol=QUAT_ATOL)


def test_transform_matches_jax(rng):
    for q, t, q2, t2, p in zip(random_rotations(rng, 8), rng.randn(8, 3),
                               random_rotations(rng, 8), rng.randn(8, 3),
                               rng.randn(8, 5, 3)):
        a, b = TT.Transform(TT.Rotation(q), t), TT.Transform(TT.Rotation(q2), t2)
        ja = JT.Transform(JT.Rotation(q), t)
        jb = JT.Transform(JT.Rotation(q2), t2)
        for got, want in ((a.as_matrix(), ja.as_matrix()),
                          (a.apply(p), ja.apply(p)),
                          (a.inverse().as_matrix(), ja.inverse().as_matrix()),
                          ((a * b).as_matrix(), (ja * jb).as_matrix()),
                          (a.to_list(), ja.to_list()),
                          (TT.Transform.from_matrix(a.as_matrix()).to_list(),
                           JT.Transform.from_matrix(ja.as_matrix()).to_list()),
                          (TT.Rotation.from_rotvec(t).as_quat(),
                           JT.Rotation.from_rotvec(t).as_quat()),
                          (TT.Transform.look_at(t, t2, [0, 0, 1]).as_matrix(),
                           JT.Transform.look_at(t, t2, [0, 0, 1]).as_matrix())):
            np.testing.assert_allclose(got, want, rtol=0, atol=QUAT_ATOL)
        np.testing.assert_allclose(a.inverse().apply(a.apply(p)), p,
                                   atol=1e-9)
    assert TT.Transform.identity().to_list() == JT.Transform.identity().to_list()


def test_grasp_voxel_coordinates_match_jax():
    pose = TT.Transform(TT.Rotation([0.1, 0.2, 0.3, 0.9]), [0.03, 0.06, 0.09])
    g = to_voxel_coordinates(Grasp(pose, 0.04), 0.0075)
    jg = JGrasp(JT.Transform(JT.Rotation([0.1, 0.2, 0.3, 0.9]),
                             [0.03, 0.06, 0.09]), 0.04)
    from graspnerf_tpu.sim.grasp import to_voxel_coordinates as j_to_vox
    jv = j_to_vox(jg, 0.0075)
    np.testing.assert_array_equal(g.pose.translation, jv.pose.translation)
    assert g.width == jv.width
    back = from_voxel_coordinates(g, 0.0075)
    np.testing.assert_allclose(back.pose.translation, pose.translation,
                               atol=1e-12)
    pose_, width = back
    assert width == pytest.approx(0.04) and pose_ is back.pose
    assert int(Label.SUCCESS) == 1 and int(Label.FAILURE) == 0


# ------------------------------------------------------------ primitives
def _scenes(rng, n=5):
    """The same random scene in both packages (and a cube mesh), built from
    one draw of `rng`."""
    objs = []
    for _ in range(n):
        ob = JO.random_object(rng)
        ob.R = JT.Rotation.from_quat(random_rotations(rng, 1)[0]).as_matrix(
            ).astype(np.float32)
        ob.t = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        ob.t[2] = rng.uniform(0.02, 0.15)
        objs.append(ob.state())
    j = JO.PrimScene([JO.PrimObject.from_state(s) for s in objs])
    t = TO.PrimScene([TO.PrimObject.from_state(s) for s in objs])
    return t, j


def _cube(pkg, h=0.02, t=(0.05, -0.04, 0.03)):
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float32)
    f = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                  (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                  (1, 5, 7), (1, 7, 3)], np.int32)
    return pkg.MeshObject(v, f, t=t, material=3)


def _rays_at(scene, rng, n=600):
    idx = rng.randint(len(scene), size=n)
    target = np.stack([scene.objects[i].t for i in idx]) + rng.randn(n, 3) * 0.01
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (target - d * 0.5).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("tracer", ["native", "numpy"])
def test_prim_scene_trace_matches_jax(rng, tracer, request):
    """PrimScene.trace (primitives and a triangle mesh, with and without
    the table, one object excluded) bit-equal to JAX's, through the native
    tracer (one build for both) and through the numpy intersects."""
    if tracer == "native" and not t_native.available():
        pytest.skip("no C++ compiler: the port traces with numpy")
    request.getfixturevalue("same_tracer" if tracer == "native"
                            else "numpy_tracers")
    t_scene, j_scene = _scenes(rng)
    t_scene.add(_cube(TM))
    j_scene.add(_cube(JM))
    o, d = _rays_at(t_scene, rng)
    before = dict(TO.TRACES)
    for kw in ({}, {"with_table": False}, {"exclude": 2}):
        got = t_scene.trace(o, d, **kw)
        want = j_scene.trace(o, d, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert np.isfinite(got[0]).mean() > 0.5
    assert TO.TRACES[tracer] - before[tracer] == 3 * len(o)
    # the port's native wrappers against the JAX package's, on one library
    if tracer == "native":
        prims = np.stack([ob.flat() for ob in t_scene.objects[:-1]])
        for g, w in zip(t_native.trace_prims(prims, o, d),
                        j_native.trace_prims(prims, o, d)):
            np.testing.assert_array_equal(g, w)
        tris = t_scene.objects[-1].world_triangles()
        ids = np.full(len(tris), 7, np.int32)
        for g, w in zip(t_native.trace_tris(tris, ids, o, d),
                        j_native.trace_tris(tris, ids, o, d)):
            np.testing.assert_array_equal(g, w)


def test_prim_queries_match_jax(rng):
    """sdf, intersect, surface_points and the size properties of every
    primitive kind, posed."""
    t_scene, j_scene = _scenes(np.random.RandomState(4), 8)
    pts = rng.uniform(-0.12, 0.12, (300, 3)).astype(np.float32)
    o, d = _rays_at(t_scene, rng, 200)
    for a, b in zip(t_scene.objects, j_scene.objects):
        np.testing.assert_array_equal(a.sdf(pts), b.sdf(pts))
        for g, w in zip(a.intersect(o, d), b.intersect(o, d)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            a.surface_points(64, np.random.RandomState(1)),
            b.surface_points(64, np.random.RandomState(1)))
        for k in ("radius_bound", "min_width", "volume"):
            assert getattr(a, k) == getattr(b, k), k
        np.testing.assert_array_equal(a.flat(), b.flat())
    np.testing.assert_array_equal(
        t_scene.sdf(pts, exclude=1, with_table=True),
        j_scene.sdf(pts, exclude=1, with_table=True))


@pytest.mark.parametrize("scene_type,seed", [("pile", 3), ("pile", 8),
                                             ("packed", 3), ("single", 5)])
def test_scene_generation_matches_jax(scene_type, seed, same_tracer):
    """ClutterRemovalSim.reset: the same objects, poses and materials, and
    the generator's rng left in the same state."""
    sim = TS.ClutterRemovalSim(scene_type, rng=np.random.RandomState(seed),
                               device="cpu")
    jsim = JS.ClutterRemovalSim(scene_type, rng=np.random.RandomState(seed))
    n = 1 if scene_type == "single" else 5
    sim.reset(n)
    jsim.reset(n)
    assert sim.num_objects >= 1
    assert_objects_equal(sim.scene.objects, jsim.scene.objects)
    assert sim.rng.randint(2 ** 31) == jsim.rng.randint(2 ** 31)


# -------------------------------------------------------------- renderer
def test_textures_equal_pil_decode():
    """The port's committed texture arrays equal PIL's decode of the JAX
    package's PNGs; its env maps equal the JAX package's; the banks load
    in the same order with the same values."""
    from PIL import Image
    src = os.path.join(REPO, "graspnerf_tpu", "assets", "textures")
    dst = os.path.join(REPO, "graspnerf_tpu_torch", "assets", "textures")
    pngs = sorted(f for f in os.listdir(src) if f.endswith(".png"))
    assert sorted(os.listdir(dst)) == [f[:-4] + ".npz" for f in pngs]
    for f in pngs:
        want = np.asarray(Image.open(os.path.join(src, f)).convert("RGB"))
        got = np.load(os.path.join(dst, f[:-4] + ".npz"))["img"]
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for g, w in zip(TR.load_texture_bank(), JR.load_texture_bank()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(TR.load_env_bank(), JR.load_env_bank()):
        np.testing.assert_array_equal(g, w)
    assert len(TR.load_texture_bank()) == len(JR.load_texture_bank()) == 6
    assert len(TR.load_env_bank()) == len(JR.load_env_bank()) == 4


def _render_pair(seed, materials=None, n=5):
    sim = TS.ClutterRemovalSim("pile", rng=np.random.RandomState(seed),
                               device="cpu")
    jsim = JS.ClutterRemovalSim("pile", rng=np.random.RandomState(seed))
    sim.reset(n)
    jsim.reset(n)
    for i, m in enumerate(materials or []):
        sim.scene.objects[i].material = jsim.scene.objects[i].material = m
    dr = TR.DomainRandomizer(np.random.RandomState(seed)).init_scene(
        sim.scene)
    jdr = JR.DomainRandomizer(np.random.RandomState(seed)).init_scene(
        jsim.scene)
    return sim, jsim, dr, jdr


@pytest.mark.parametrize("seed,materials", [
    (11, None), (2, None), (3, [JR.MATERIAL_CLASSES.index("glass")] * 2),
    (6, [JR.MATERIAL_CLASSES.index("wood"),
         JR.MATERIAL_CLASSES.index("leather")])])
def test_render_scene_matches_jax(seed, materials, same_tracer):
    """render_scene's RGB, depth, mask and normals bit-equal (domain
    randomized, glass bounces, image and procedural textures), the flat
    fallback too, and after an object leaves the scene."""
    sim, jsim, dr, jdr = _render_pair(seed, materials)
    K = intrinsics(48, 64)
    poses = hemisphere_poses()
    for pose in poses[[2, 13, 22]]:
        for r, jr in ((dr, jdr), (None, None)):
            got = TR.render_scene(sim.scene, pose, K, 48, 64, r,
                                  return_normal=True)
            want = JR.render_scene(jsim.scene, pose, K, 48, 64, jr,
                                   return_normal=True)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        assert got[2].any()
    sim.scene.remove(0)
    jsim.scene.remove(0)
    dr.update_sceneobj(sim.scene)
    jdr.update_sceneobj(jsim.scene)
    for g, w in zip(TR.render_scene(sim.scene, poses[6], K, 48, 64, dr),
                    JR.render_scene(jsim.scene, poses[6], K, 48, 64, jdr)):
        np.testing.assert_array_equal(g, w)


def test_ir_stereo_matches_jax(same_tracer):
    sim, jsim, dr, jdr = _render_pair(9)
    K = intrinsics(32, 48)
    pose = hemisphere_poses()[10]
    for g, w in zip(TR.render_ir_stereo(sim.scene, pose, K, 32, 48, dr),
                    JR.render_ir_stereo(jsim.scene, pose, K, 32, 48, jdr)):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- meshes
def _write_cube_urdf(dirpath, name="cube", h=0.02, scale=1.0):
    """An OBJ cube of outward quads and a URDF that names it."""
    v = [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)]
    quads = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
             (1, 3, 7, 5), (2, 6, 8, 4)]
    with open(os.path.join(dirpath, f"{name}.obj"), "w") as f:
        f.writelines(f"v {p[0]} {p[1]} {p[2]}\n" for p in v)
        f.writelines("f " + " ".join(f"{i}/1/1" for i in q) + "\n"
                     for q in quads)
    urdf = os.path.join(dirpath, f"{name}.urdf")
    with open(urdf, "w") as f:
        f.write(f"""<?xml version="1.0"?>
<robot name="{name}"><link name="base">
  <visual><geometry><mesh filename="{name}.obj"/></geometry></visual>
  <collision><geometry>
    <mesh filename="package://{name}.obj" scale="{scale} {scale} {scale}"/>
  </geometry></collision>
</link></robot>""")
    return urdf


def test_mesh_object_matches_jax(tmp_path, rng):
    urdf = _write_cube_urdf(str(tmp_path), scale=1.5)
    assert TM.mesh_from_urdf(urdf)[0] == JM.mesh_from_urdf(urdf)[0]
    np.testing.assert_array_equal(TM.mesh_from_urdf(urdf)[1],
                                  JM.mesh_from_urdf(urdf)[1])
    path = TM.mesh_from_urdf(urdf)[0]
    for g, w in zip(TM.load_obj(path), JM.load_obj(path)):
        np.testing.assert_array_equal(g, w)
    R = JT.Rotation.from_quat(random_rotations(rng, 1)[0]).as_matrix()
    a = TM.MeshObject(*TM.load_obj(path), R=R, t=[0.01, 0.02, 0.03],
                      scale=1.3)
    b = JM.MeshObject(*JM.load_obj(path), R=R, t=[0.01, 0.02, 0.03],
                      scale=1.3)
    pts = rng.uniform(-0.06, 0.08, (200, 3)).astype(np.float32)
    o = rng.uniform(-0.3, 0.3, (200, 3)).astype(np.float32)
    d = (a.t - o) / np.linalg.norm(a.t - o, axis=-1, keepdims=True)
    np.testing.assert_array_equal(a.sdf(pts), b.sdf(pts))
    for g, w in zip(a.intersect(o, d.astype(np.float32)),
                    b.intersect(o, d.astype(np.float32))):
        np.testing.assert_array_equal(g, w)
    for k in ("radius_bound", "min_width", "volume"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.world_triangles(), b.world_triangles())
    st = TM.MeshObject.from_state(a.state()).state()
    for k, v in b.state().items():
        np.testing.assert_array_equal(st[k], v)


@pytest.mark.parametrize("scene", ["pile", "packed"])
def test_mesh_pose_list_roundtrip_matches_jax(tmp_path, scene, same_tracer):
    """A reference-format descriptor written by the port reads back in both
    packages to the same entries, and replays into the same scene."""
    root = str(tmp_path)
    urdfs = [os.path.basename(_write_cube_urdf(root, f"c{i}", h))
             for i, h in enumerate((0.015, 0.02, 0.025))]
    rng = np.random.RandomState(6)
    d = {}
    for i, u in enumerate(urdfs):
        if scene == "packed":
            d[i] = [1.0, rng.uniform(0, np.pi), 0.1 + 0.04 * i, 0.15, u]
        else:
            d[i] = [1.0, random_rotations(rng, 1)[0].astype(np.float32),
                    np.array([0.1 + 0.04 * i, 0.15], np.float32), u]
    src = os.path.join(root, "spawn.npy")
    np.save(src, np.array(d, dtype=object), allow_pickle=True)
    got = TM.load_mesh_pose_list(src, root, scene)
    want = JM.load_mesh_pose_list(src, root, scene)
    assert [e["urdf"] for e in got] == [e["urdf"] for e in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["drop_t"], w["drop_t"])
        np.testing.assert_array_equal(g["mesh"].R, w["mesh"].R)
        assert g["rest"] == w["rest"]
    # rest poses written by the port, read back by both
    rest = os.path.join(root, "rest.npy")
    TM.save_mesh_pose_list(rest, got, scene)
    back_t = TM.load_mesh_pose_list(rest, root, "pile")
    back_j = JM.load_mesh_pose_list(rest, root, "pile")
    for g, w, e in zip(back_t, back_j, got):
        np.testing.assert_array_equal(g["drop_t"], w["drop_t"])
        np.testing.assert_allclose(g["drop_t"], e["mesh"].t, atol=1e-6)
        assert g["rest"] and w["rest"]
    # replay through the simulators: the packed entries, one pile drop
    replay = src
    if scene == "pile":
        replay = os.path.join(root, "drop.npy")
        np.save(replay, np.array({0: d[0]}, dtype=object), allow_pickle=True)
    sim = TS.ClutterRemovalSim(scene, rng=np.random.RandomState(1),
                               device="cpu")
    jsim = JS.ClutterRemovalSim(scene, rng=np.random.RandomState(1))
    sim.reset_from_mesh_pose_list(replay, root)
    jsim.reset_from_mesh_pose_list(replay, root)
    assert sim.num_objects >= 1
    assert_objects_equal(sim.scene.objects, jsim.scene.objects)


def test_descriptor_roundtrip_across_packages(tmp_path, same_tracer):
    """PrimScene.save of one package loads in the other (a mesh object
    included) and replays into the same scene."""
    sim = TS.ClutterRemovalSim("pile", rng=np.random.RandomState(5),
                               device="cpu")
    sim.reset(4)
    sim.scene.add(_cube(TM))
    path = str(tmp_path / "scene.npz")
    sim.save_descriptor(path)
    jsim = JS.ClutterRemovalSim("pile")
    jsim.reset_from_descriptor(path)
    assert_objects_equal(jsim.scene.objects, sim.scene.objects)
    jpath = str(tmp_path / "jscene.npz")
    jsim.save_descriptor(jpath)
    back = TS.ClutterRemovalSim("pile", device="cpu")
    back.reset_from_descriptor(jpath)
    assert_objects_equal(back.scene.objects, sim.scene.objects)
    assert isinstance(back.scene.objects[-1], TM.MeshObject)


# ----------------------------------------------------- the gripper, TSDF
def _top_down(pkg, x, y, z):
    R = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    R[:, 0] = np.cross(R[:, 1], R[:, 2])
    return pkg.Transform(pkg.Rotation.from_matrix(R), [x, y, z])


GRASP_CASES = {
    # tests/test_simulation.py's cases: success, empty space, a pregrasp
    # below the table, too wide (with and without contact allowed), pinned
    "success": ([(JO.TYPE_CYLINDER, [0.02, 0.04, 0], [0.0, 0.0, 0.04])],
                (0.0, 0.0, 0.05), 0.06, False),
    "empty": ([(JO.TYPE_CYLINDER, [0.02, 0.04, 0], [0.0, 0.0, 0.04])],
              (0.1, 0.1, 0.05), 0.06, False),
    "below_table": ([(JO.TYPE_CYLINDER, [0.02, 0.04, 0], [0.0, 0.0, 0.04])],
                    (0.0, 0.0, -0.02), 0.06, False),
    "too_wide": ([(JO.TYPE_BOX, [0.06, 0.06, 0.02], [0.0, 0.0, 0.02])],
                 (0.0, 0.0, 0.02), 0.08, False),
    "too_wide_contact": ([(JO.TYPE_BOX, [0.06, 0.06, 0.02],
                           [0.0, 0.0, 0.02])], (0.0, 0.0, 0.02), 0.08, True),
    "pinned": ([(JO.TYPE_BOX, [0.015, 0.03, 0.015], [0.0, 0.0, 0.015]),
                (JO.TYPE_BOX, [0.05, 0.05, 0.01], [0.0, 0.0, 0.04])],
               (0.0, 0.0, 0.02), 0.08, True),
}


@pytest.mark.parametrize("case", sorted(GRASP_CASES))
def test_execute_grasp_matches_jax(case, same_tracer):
    """execute_grasp's label, width and remaining objects, and the pinned
    check, equal to JAX's."""
    objs, xyz, width, contact = GRASP_CASES[case]
    out = []
    for pkg, O, S, kw in ((TT, TO, TS, {"device": "cpu"}), (JT, JO, JS, {})):
        sim = S.ClutterRemovalSim("pile", rng=np.random.RandomState(0), **kw)
        sim.scene = O.PrimScene([O.PrimObject(k, p, t=t) for k, p, t in objs])
        pinned = [sim._pinned_from_above(i) for i in range(len(objs))]
        (label, w), remaining = sim.execute_grasp(
            (_top_down(pkg, *xyz), width), remove=True,
            allow_contact=contact)
        out.append((int(label), w, pinned, remaining))
    (label, w, pinned, remaining), (jlabel, jw, jpinned, jremaining) = out
    assert (label, w, pinned) == (jlabel, jw, jpinned)
    assert len(remaining) == len(jremaining)
    for a, b in zip(remaining, jremaining):
        for k in ("R", "t", "params"):
            np.testing.assert_array_equal(a[k], b[k])
    if case == "success":
        assert label == Label.SUCCESS and abs(w - 0.04) < 5e-3
    if case == "pinned":
        assert pinned == [True, False]


def test_acquire_tsdf_matches_jax(same_tracer):
    """ClutterRemovalSim.acquire_tsdf: both grids within TSDF_ATOL of JAX's,
    the unobserved voxels (-1) the same, numpy float32 out."""
    sim = TS.ClutterRemovalSim("pile", rng=np.random.RandomState(7),
                               device="cpu")
    jsim = JS.ClutterRemovalSim("pile", rng=np.random.RandomState(7))
    sim.reset(3)
    jsim.reset(3)
    got = sim.acquire_tsdf(n_views=4, resolution=20, high_resolution=30,
                           h=32, w=40)
    want = jsim.acquire_tsdf(n_views=4, resolution=20, high_resolution=30,
                             h=32, w=40)
    for g, w, res in zip(got[:2], want[:2], (20, 30)):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert g.shape == (res,) * 3
        np.testing.assert_array_equal(g == -1.0, w == -1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=TSDF_ATOL)
        assert (np.abs(g) < 0.5).any()
    assert got[2] >= 0


# --------------------------------------------------------------------- IO
def test_experiment_io_matches_jax(tmp_path):
    """setup.json, rounds.csv and grasps.csv written by the port read back
    in both packages; scene descriptors cross between them."""
    for pkg, d in ((TIO, tmp_path / "t"), (JIO, tmp_path / "j")):
        pkg.write_setup(str(d), False, 1.0, 0.08, 0.05)
        pkg.append_round(str(d), 0, 3)
        for i in range(3):
            pose = TT.Transform(TT.Rotation([0.1 * i, 0.2, 0.3, 0.9]),
                                [0.01 * i, 0.02, 0.03])
            pkg.append_grasp(str(d), 0, "s", (pose, 0.05), 0.9, i % 2,
                             0.1, 0.2)
    for name in ("setup.json", "rounds.csv", "grasps.csv"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())
    assert TIO.read_setup(str(tmp_path / "t")) == JIO.read_setup(
        str(tmp_path / "t"))
    for g, w in zip(TIO.read_grasps(str(tmp_path / "t")),
                    JIO.read_grasps(str(tmp_path / "t"))):
        assert g["label"] == w["label"] and g["width"] == w["width"]
        np.testing.assert_array_equal(g["pose"].as_matrix(),
                                      w["pose"].as_matrix())
    mpl = [("a.urdf", 1.0, np.eye(4)), ("b.urdf", 0.5, 2 * np.eye(4))]
    sid = TIO.write_scene(str(tmp_path / "scenes"), mpl)
    for (p, s, m), (jp, js, jm) in zip(
            TIO.read_scene(str(tmp_path / "scenes"), sid),
            JIO.read_scene(str(tmp_path / "scenes"), sid)):
        assert (p, s) == (jp, js)
        np.testing.assert_array_equal(m, jm)
