"""The port's geometry, kinematics, image, sampler and aggregation modules against the JAX
package on the same numpy inputs (f32, CPU).

Bars: geometry helpers rtol 1e-5; MANO vertices within 1e-6 m; aggregation fed the JAX
package's own candidates gives identical top-k selections and fused outputs within 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.diffusion import sampler as jax_sampler
from vpho_tpu.diffusion.sde import init_sde as jax_init_sde
from vpho_tpu.models import aggregation as jagg
from vpho_tpu.models import anchor as janchor
from vpho_tpu.models import mano as jmano
from vpho_tpu.models import vpho as JV
from vpho_tpu.ops import image as jimage
from vpho_tpu.utils import transforms as JT
from vpho_tpu_torch.diffusion import sampler as tsampler
from vpho_tpu_torch.diffusion.sde import init_sde as torch_init_sde
from vpho_tpu_torch.models import aggregation as tagg
from vpho_tpu_torch.models import anchor as tanchor
from vpho_tpu_torch.models import mano as tmano
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.ops import image as timage
from vpho_tpu_torch.utils import transforms as TT

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def contexts():
    cfg = dict(sample_num=4, sampling_steps=5, topk_hand=3, topk_obj=2, patch_size=64)
    return JV.make_context(JV.ModelConfig(**cfg)), TV.make_context(TV.ModelConfig(**cfg),
                                                                   device="cpu")


def test_constants_match(contexts):
    jctx, tctx = contexts
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights"):
        np.testing.assert_array_equal(_np(getattr(tctx.mano, name)),
                                      np.asarray(getattr(jctx.mano, name)))
    for name in ("kpt3d", "verts_sampled", "com"):
        np.testing.assert_array_equal(_np(getattr(tctx.registry, name)),
                                      np.asarray(getattr(jctx.registry, name)))
    for name in ("face_vert_idx", "anchor_weight", "skeleton", "vert2joint"):
        np.testing.assert_array_equal(_np(getattr(tctx.anchor_tables, name)),
                                      np.asarray(getattr(jctx.anchor_tables, name)))


def test_rotation_conversions():
    rng = np.random.RandomState(0)
    aa = (rng.randn(64, 3) * 1.2).astype(np.float32)
    aa[0] = 0.0
    d6 = rng.randn(64, 6).astype(np.float32)
    close(TT.axis_angle_to_quaternion(_t(aa)), JT.axis_angle_to_quaternion(aa))
    close(TT.axis_angle_to_matrix(_t(aa)), JT.axis_angle_to_matrix(aa))
    m = JT.rotation_6d_to_matrix(d6)
    close(TT.rotation_6d_to_matrix(_t(d6)), m)
    close(TT.matrix_to_quaternion(_t(np.asarray(m))), JT.matrix_to_quaternion(m))
    close(TT.matrix_to_axis_angle(_t(np.asarray(m))), JT.matrix_to_axis_angle(m), atol=1e-5)
    q = JT.axis_angle_to_quaternion(aa)
    close(TT.quaternion_to_axis_angle(_t(np.asarray(q))), JT.quaternion_to_axis_angle(q),
          atol=1e-5)


def test_average_quaternion_and_rot6d():
    rng = np.random.RandomState(1)
    base = rng.randn(5, 1, 3) * 0.8
    aa = (base + rng.randn(5, 7, 3) * 0.2).astype(np.float32)
    q = np.asarray(JT.axis_angle_to_quaternion(aa))
    w = rng.rand(5, 7).astype(np.float32)
    close(TT.average_quaternion(_t(q), _t(w)), JT.average_quaternion(q, w), atol=1e-5)
    close(TT.average_quaternion(_t(q)), JT.average_quaternion(q), atol=1e-5)
    d6 = np.asarray(JT.matrix_to_rotation_6d(JT.axis_angle_to_matrix(aa)))
    close(TT.average_rot6d(_t(d6), _t(w)), JT.average_rot6d(d6, w), atol=1e-5)


def test_projection_and_flip():
    rng = np.random.RandomState(2)
    pt = (rng.randn(3, 5, 4, 3) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    K = np.tile(np.array([[140.0, 0, 32], [0, 140.0, 32], [0, 0, 1]], np.float32), (3, 1, 1))
    close(TT.project_points_batched(_t(pt), _t(K)), JT.project_points_batched(pt, K))
    flip = np.array([True, False, True])
    close(TT.flip_point3d(_t(pt), _t(flip)), JT.flip_point3d(pt, flip))


def test_mano_fk(contexts):
    jctx, tctx = contexts
    rng = np.random.RandomState(3)
    pose = (rng.randn(6, 48) * 0.4).astype(np.float32)
    shape = (rng.randn(6, 10) * 0.5).astype(np.float32)
    jv, jj = jax.jit(lambda p, s: jmano.hand_verts_meters(jctx.mano, p, s))(pose, shape)
    tv, tj = tmano.hand_verts_meters(tctx.mano, _t(pose), _t(shape))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(tj), np.asarray(jj), rtol=0, atol=1e-6)
    jjo = jmano.hand_joints_meters(jctx.mano, pose.reshape(2, 3, 48), shape.reshape(2, 3, 10))
    tjo = tmano.hand_joints_meters(tctx.mano, _t(pose).reshape(2, 3, 48), _t(shape).reshape(2, 3, 10))
    np.testing.assert_allclose(_np(tjo), np.asarray(jjo), rtol=0, atol=1e-6)


def test_force_local_to_global(contexts):
    jctx, tctx = contexts
    rng = np.random.RandomState(4)
    verts, _ = jmano.hand_verts_meters(jctx.mano, (rng.randn(2, 3, 48) * 0.3).astype(np.float32),
                                       np.zeros((2, 3, 10), np.float32))
    fl = (rng.randn(2, 3, 32, 3) * 0.1).astype(np.float32)
    jp, jg = janchor.force_local_to_global(jctx.anchor_tables, fl, verts)
    tp, tg = tanchor.force_local_to_global(tctx.anchor_tables, _t(fl), _t(np.asarray(verts)))
    close(tp, jp)
    close(tg, jg, atol=1e-6)


def test_image_ops():
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 16, 16, 8).astype(np.float32)                  # NHWC
    boxes = np.array([[3.0, 5.0, 40.0, 52.0], [10.0, 0.0, 63.0, 33.0]], np.float32)
    ref = np.asarray(jimage.roi_align(feat, boxes, 8)).transpose(0, 3, 1, 2)
    close(timage.roi_align(_t(feat).permute(0, 3, 1, 2), _t(boxes), 8), ref)
    hm = rng.rand(2, 5, 16, 16).astype(np.float32)
    xs = (rng.rand(2, 16) * 18 - 1).astype(np.float32)
    ys = (rng.rand(2, 16) * 18 - 1).astype(np.float32)
    close(timage.resample_rectilinear(_t(hm), _t(xs), _t(ys)),
          jimage.resample_rectilinear(hm, xs, ys))
    for size in ((8, 8), (32, 32)):
        close(timage.resize_bilinear(_t(hm), size), jimage.resize_bilinear(hm, size))
    pts = (rng.rand(2, 6, 5, 2) * 2.4 - 1.2).astype(np.float32)
    close(timage.sample_points(_t(hm), _t(pts)), jimage.sample_points(hm, pts, "bicubic"))


def test_dpm3m_sampler():
    jsde, tsde = jax_init_sde("ve"), torch_init_sde("ve")
    mu = np.linspace(-1, 1, 7).astype(np.float32)

    def jscore(x, t):
        std = jsde.marginal_prob(x, t)[1]
        return -(x - mu) / (std ** 2 + 0.1)

    def tscore(x, t):
        std = tsde.marginal_prob(None, t)[1]
        return -(x - torch.from_numpy(mu)) / (std ** 2 + 0.1)

    x0 = jsde.prior(jax.random.PRNGKey(0), (5, 7), T=0.65)
    _, ref = jax_sampler.ode_sampler(jscore, jax.random.PRNGKey(0), 5, 7, jsde, 0.65, 9,
                                     method="dpm3m", return_trajectory=False)
    got = tsampler.ode_sampler(tscore, _t(np.asarray(x0)), tsde, 0.65, 9)
    close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def agg_inputs(contexts):
    jctx, _ = contexts
    B, S = 3, 6
    batch = {k: np.asarray(v) for k, v in
             jax_make_batch(jctx, jax.random.PRNGKey(4), B, 64).items()}
    rng = np.random.RandomState(6)
    d6 = np.asarray(JT.matrix_to_rotation_6d(JT.axis_angle_to_matrix(
        rng.randn(B, S, 3).astype(np.float32) * 0.5)))
    return dict(
        cam_intrinsic=batch["cam_intr_crop_flip"], root_joint_flip=batch["root_joint_flip"],
        root_joint=batch["root_joint"], is_right=np.array([True, False, True]),
        force_local=(rng.randn(B, 32, 3) * 0.1).astype(np.float32),
        is_grasped=np.array([1.0, 1.0, 0.0], np.float32),
        hand_pose_diff=(rng.randn(B, S, 48) * 0.3).astype(np.float32),
        hand_pose_regression=(rng.randn(B, 48) * 0.3).astype(np.float32),
        hand_shape=np.repeat((rng.randn(B, 1, 10) * 0.3).astype(np.float32), S, 1),
        hand_heatmap=rng.rand(B, 21, 64, 64).astype(np.float32),
        hand_bbox=batch["bbox_hand"], hand_topk=4,
        obj_pose6d=np.concatenate([d6, (rng.randn(B, S, 3) * 0.03).astype(np.float32)], -1),
        obj_heatmap=rng.rand(B, 27, 64, 64).astype(np.float32),
        obj_bbox=batch["bbox_obj_rect"], obj_topk=3, obj_ids=batch["obj_id"],
    )


def test_hand_cascade_selections(contexts, agg_inputs):
    jctx, tctx = contexts
    a = agg_inputs
    args = ("hand_pose_diff", "hand_pose_regression", "hand_shape", "root_joint_flip",
            "cam_intrinsic", "hand_heatmap", "hand_bbox")

    def jax_cascade(*xs):
        out = jagg.hand_heatmap_cascade(jctx.mano, *xs, a["hand_topk"])
        return [lv.topk for lv in out["middle_data"]], out["agg_hand_mano"]

    ref_topk, ref_mano = jax.jit(jax_cascade)(*[a[k] for k in args])
    got = tagg.hand_heatmap_cascade(tctx.mano, *[_t(a[k]) for k in args], a["hand_topk"])
    for lr, lg in zip(ref_topk, got["middle_data"]):
        np.testing.assert_array_equal(_np(lg.topk), np.asarray(lr))
    close(got["agg_hand_mano"], ref_mano, rtol=0, atol=5e-4)


@pytest.mark.parametrize("flags", [(True, True, True), (False, False, False)],
                         ids=["default", "all_off"])
def test_hoi_aggregate(contexts, agg_inputs, flags):
    jctx, tctx = contexts
    a = agg_inputs
    ints = ("hand_topk", "obj_topk")
    kw = dict(zip(("is_weight", "use_regression_as_candidate", "do_physics_selection"), flags))
    jax_hoi = jax.jit(lambda arrays: jagg.hoi_aggregate(
        jctx.mano, jctx.registry, jctx.anchor_tables, hand_topk=a["hand_topk"],
        obj_topk=a["obj_topk"], **kw, **arrays))
    ref = jax_hoi({k: v for k, v in a.items() if k not in ints})
    got = tagg.hoi_aggregate(tctx.mano, tctx.registry, tctx.anchor_tables, **kw,
                             **{k: (v if k in ints else _t(v)) for k, v in a.items()})
    for key in ("obj_agg_6d", "hand_agg_mano", "hand_agg_vert", "hand_agg_joint", "agg_obj_vert"):
        close(got[key], ref[key], rtol=0, atol=5e-4)


def test_object_rankers(contexts, agg_inputs):
    jctx, tctx = contexts
    a = agg_inputs
    common = ("obj_pose6d", "root_joint", "obj_ids", "is_right")
    hm = ("cam_intrinsic", "obj_heatmap", "obj_bbox")

    def jax_rankers(c, h, pose, shape, fl, root_flip):
        verts, _ = jmano.hand_verts_meters(jctx.mano, pose, shape)
        fp, fg = janchor.force_local_to_global(jctx.anchor_tables, fl, verts + root_flip[:, None])
        return (jagg.obj_topk_by_heatmap(jctx.registry, *c, *h, 3),
                jagg.obj_topk_by_physics3(jctx.registry, *c, fp, fg, 4)[0], fp, fg)

    (jt, jw), jp, fp, fg = jax.jit(jax_rankers)(
        [a[k] for k in common], [a[k] for k in hm], a["hand_pose_regression"],
        a["hand_shape"][:, 0], a["force_local"], a["root_joint_flip"])
    tt, tw = tagg.obj_topk_by_heatmap(tctx.registry, *[_t(a[k]) for k in common + hm], 3)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    close(tw, jw)
    tp, _ = tagg.obj_topk_by_physics3(tctx.registry, *[_t(a[k]) for k in common],
                                      _t(fp), _t(fg), 4)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
