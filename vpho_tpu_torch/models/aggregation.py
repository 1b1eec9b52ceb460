"""Multi-hypothesis cue aggregation (counterpart of ``vpho_tpu/models/aggregation.py``).

The default predict path runs the 5-stage HOI orchestration ``hoi_aggregate``:

  1. hand heatmap cascade over 4 kinematic levels (regression pose injected as candidates)
  2. object translation top-k by heatmap, fused
  3. object rotation top-k with the fused translation substituted
  4. k x k cross-product candidates re-ranked by physics (grasped) or heatmap
  5. per-finger physics re-rank of the distal/tip hand parameters

The other ``--aggregation_mode_hand/obj`` choices run the standalone aggregators
(``aggregate_hand``, ``aggregate_obj``).  Top-k selections order scores exactly as
``jax.lax.top_k`` does (``top_k`` below).  Every nearest-vertex search (stages 4 and 5, and the
standalone object cascade's force selection) goes through K2 (``ops/min_dist.py``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from ..ops.image import sample_points
from ..ops.min_dist import min_dist_and_idx
from ..utils import transforms as T
from ..utils.hand import MANO_JOINT_LEVEL, MANO_PARAMS_LEVEL
from . import anchor as anchor_lib
from . import heads
from .mano import MANOModel, hand_joints_meters, hand_verts_meters
from .ycb import YCBRegistry


def top_k(score: torch.Tensor, k: int):
    """(values, indices) of the k largest float32 scores along the last axis, ordered as
    ``jax.lax.top_k`` orders them: IEEE total order (+0.0 above -0.0) and, on exact ties, the
    lower index first."""
    bits = score.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)          # monotone in total order
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(score, -1, idx), idx


def normalize_pt2d_to_bbox(pt2d: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Image points (B, ..., 2) -> [-1, 1] bbox-normalized coords; bbox (B, 4) xyxy."""
    b = bbox.reshape(bbox.shape[0], *([1] * (pt2d.dim() - 2)), 4)
    return 2.0 * (pt2d - b[..., :2]) / (b[..., 2:] - b[..., :2]) - 1.0


def heat_values(heatmap: torch.Tensor, pt2d_norm: torch.Tensor,
                observe_index: Sequence[int]) -> torch.Tensor:
    """heatmap (B, J, H, W); pt2d_norm (B, N, J, 2) -> bicubic heat (B, N, m)."""
    obs = list(observe_index)
    return sample_points(heatmap[:, obs], pt2d_norm[:, :, obs], mode="bicubic")


def take_candidates(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), idx (B, K) -> (B, K, ...)."""
    idxe = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idxe)


class HandLevelData(NamedTuple):
    val: torch.Tensor
    topk: torch.Tensor
    fused_idx_pose: torch.Tensor
    topk_idx_pose_aa: torch.Tensor
    fused_pose: torch.Tensor


def select_topk_hand_level(mano: MANOModel, pose, shape, root_joint, cam_intrinsic, heatmap,
                           bbox, k: int, fuse_index: Sequence[int],
                           observe_index: Sequence[int], is_independent: bool,
                           is_weight: bool) -> HandLevelData:
    """One cascade level: score candidates by heat at their projected joints, fuse the top-k
    quaternions of ``fuse_index`` and write them into every candidate."""
    B, N = pose.shape[:2]
    joint = hand_joints_meters(mano, pose, shape) + root_joint[:, None, None]
    pt2d = normalize_pt2d_to_bbox(T.project_points_batched(joint, cam_intrinsic), bbox)
    hv = heat_values(heatmap, pt2d, observe_index)                   # (B, N, m)
    fuse_idx = list(fuse_index)
    if not is_independent:
        val, topk = top_k(hv.sum(-1), k)
        weight = (val + 1e-8) / (val.sum(1, keepdim=True) + 1e-8)
        topk_pose_aa = take_candidates(pose, topk)[:, :, fuse_idx].reshape(B, k, -1, 3)
        quat = T.axis_angle_to_quaternion(topk_pose_aa).transpose(1, 2)  # (B, n, K, 4)
        fused_quat = T.average_quaternion(quat, weight[:, None] if is_weight else None)
    else:
        n = len(fuse_idx) // 3
        score = hv.reshape(B, N, len(observe_index) // n, n).mean(-2)    # (B, N, n)
        val, topk = top_k(score.transpose(1, 2), k)                      # (B, n, K)
        val, topk = val.transpose(1, 2), topk.transpose(1, 2)            # (B, K, n)
        weight = ((val + 1e-8) / (val.sum(1, keepdim=True) + 1e-8)).permute(0, 2, 1)
        joint_of_param = torch.tensor(fuse_idx, device=pose.device).reshape(-1, 3)[:, 0] // 3
        pose_j = pose.reshape(B, N, 16, 3)
        bi = torch.arange(B, device=pose.device)[:, None, None]
        topk_pose_aa = pose_j[bi, topk, joint_of_param[None, None, :]]  # (B, K, n, 3)
        quat = T.axis_angle_to_quaternion(topk_pose_aa).transpose(1, 2)
        fused_quat = T.average_quaternion(quat, weight if is_weight else None)
    fused_aa = T.quaternion_to_axis_angle(fused_quat).reshape(B, -1)
    fused_pose = pose.clone()
    fused_pose[:, :, fuse_idx] = fused_aa[:, None].expand(B, N, len(fuse_idx))
    return HandLevelData(val, topk, fused_aa, topk_pose_aa, fused_pose)


def hand_heatmap_cascade(mano: MANOModel, pose, pose_regression, shape, root_joint,
                         cam_intrinsic, heatmap, bbox, k: int, is_weight: bool = True,
                         use_regression_as_candidate: bool = True, n_levels: int = 4) -> Dict:
    """Wrist-to-tip cascade over (B, S, 48) candidates; ``n_levels`` < 4 truncates it."""
    B, S = pose.shape[:2]
    if use_regression_as_candidate:
        pose = torch.cat([pose, pose_regression[:, None].expand(B, S, 48)], dim=1)
        shape = torch.cat([shape, shape], dim=1)
    levels = []
    for level_i in range(n_levels):
        fuse_idx = MANO_PARAMS_LEVEL[level_i]
        observe_idx = [j for lv in range(level_i + 1, 5) for j in MANO_JOINT_LEVEL[lv]]
        if use_regression_as_candidate and level_i == 0:
            pose = pose.clone()
            pose[:, S:, fuse_idx] = pose[:, :S, fuse_idx]    # regression copies take the wrists
        data = select_topk_hand_level(mano, pose, shape, root_joint, cam_intrinsic, heatmap,
                                      bbox, k, fuse_idx, observe_idx,
                                      is_independent=level_i != 0, is_weight=is_weight)
        pose = data.fused_pose
        levels.append(data)
    fused_pose = levels[-1].fused_pose[:, 0]
    shape0 = shape[:, 0]
    fused_vert, fused_joint = hand_verts_meters(mano, fused_pose, shape0)
    return {"agg_hand_mano": torch.cat([fused_pose, shape0], dim=-1), "agg_vert": fused_vert,
            "agg_joint": fused_joint, "middle_data": levels}


def _hand_result(mano: MANOModel, pose, shape0, **extra) -> Dict:
    vert, joint = hand_verts_meters(mano, pose, shape0)
    return {"agg_hand_mano": torch.cat([pose, shape0], dim=-1), "agg_vert": vert,
            "agg_joint": joint, **extra}


def hand_average_all(mano: MANOModel, pose, shape) -> Dict:
    """Quaternion mean of every candidate."""
    B, S = pose.shape[:2]
    quat = T.axis_angle_to_quaternion(pose.reshape(B, S, 16, 3)).transpose(1, 2)
    fused = T.quaternion_to_axis_angle(T.average_quaternion(quat)).reshape(B, 48)
    return _hand_result(mano, fused, shape.reshape(B, -1, 10)[:, 0])


def hand_select_by_heatmap(mano: MANOModel, pose, shape, root_joint, cam_intrinsic, heatmap,
                           bbox, k: int, is_weight: bool = True) -> Dict:
    """One level over the whole pose, scored by the heat at all 21 joints."""
    data = select_topk_hand_level(mano, pose, shape, root_joint, cam_intrinsic, heatmap, bbox,
                                  k, fuse_index=list(range(48)), observe_index=list(range(21)),
                                  is_independent=False, is_weight=is_weight)
    return _hand_result(mano, data.fused_pose[:, 0], shape[:, 0], topk=data.topk)


def hand_select_random(mano: MANOModel, pose, shape) -> Dict:
    """Candidate 0 (the candidates are i.i.d. samples)."""
    return _hand_result(mano, pose[:, 0], shape[:, 0])


def _heatmap_peaks(heatmap: torch.Tensor) -> torch.Tensor:
    """(B, J, H, W) -> (B, J, 2) argmax positions in [-1, 1] coords (column -> x)."""
    H, W = heatmap.shape[-2:]
    ind = heatmap.flatten(2).argmax(-1)
    px = (ind % W).to(heatmap.dtype) / (W - 1) * 2 - 1
    py = (ind // W).to(heatmap.dtype) / (H - 1) * 2 - 1
    return torch.stack([px, py], dim=-1)


def hand_select_by_2d_pt(mano: MANOModel, pose, shape, root_joint, cam_intrinsic, heatmap,
                         bbox, k: int, level: str = "pose") -> Dict:
    """Rank by the distance of projected joints to the heatmap peaks.  ``level`` "pose"
    fuses the top-k whole poses; "joint" averages the top-k positions per joint (no mesh)."""
    B = pose.shape[0]
    joint = hand_joints_meters(mano, pose, shape)
    pt2d = normalize_pt2d_to_bbox(
        T.project_points_batched(joint + root_joint[:, None, None], cam_intrinsic), bbox)
    score = -torch.linalg.norm(pt2d - _heatmap_peaks(heatmap)[:, None], dim=-1)   # (B, N, J)
    if level == "pose":
        _, topk = top_k(score.sum(-1), k)
        quat = T.axis_angle_to_quaternion(
            take_candidates(pose, topk).reshape(B, k, 16, 3)).transpose(1, 2)
        fused = T.quaternion_to_axis_angle(T.average_quaternion(quat)).reshape(B, 48)
        return _hand_result(mano, fused, shape[:, 0], topk=topk)
    _, topk = top_k(score.transpose(1, 2), k)                                     # (B, J, k)
    jsel = torch.gather(joint.transpose(1, 2), 2, topk[..., None].expand(topk.shape + (3,)))
    return {"agg_hand_mano": pose.new_zeros((B, 58)), "agg_vert": pose.new_zeros((B, 778, 3)),
            "agg_joint": jsel.mean(2), "topk": topk}


def aggregate_hand(mode: str, mano: MANOModel, **kw) -> Dict:
    """``--aggregation_mode_hand`` dispatch."""
    if mode in ("heatmap_cascade", "heatmap_cascade_n_level"):
        return hand_heatmap_cascade(
            mano, kw["pose"], kw["pose_regression"], kw["shape"], kw["root_joint"],
            kw["cam_intrinsic"], kw["heatmap"], kw["bbox"], kw["k"],
            is_weight=kw.get("is_weight", True),
            use_regression_as_candidate=kw.get("use_regression_as_candidate", True),
            n_levels=kw.get("n_level", 2) if mode.endswith("n_level") else 4)
    if mode == "heatmap":
        return hand_select_by_heatmap(mano, kw["pose"], kw["shape"], kw["root_joint"],
                                      kw["cam_intrinsic"], kw["heatmap"], kw["bbox"], kw["k"],
                                      kw.get("is_weight", True))
    if mode in ("2D_pt_pose", "2D_pt_joint"):
        return hand_select_by_2d_pt(mano, kw["pose"], kw["shape"], kw["root_joint"],
                                    kw["cam_intrinsic"], kw["heatmap"], kw["bbox"], kw["k"],
                                    level="pose" if mode.endswith("pose") else "joint")
    if mode == "average_all":
        return hand_average_all(mano, kw["pose"], kw["shape"])
    if mode == "random":
        return hand_select_random(mano, kw["pose"], kw["shape"])
    raise NotImplementedError(mode)


FINGER_ANCHOR_LEVELS = ([1, 2, 3, 4], [8, 9, 10, 11], [14, 15, 16, 17], [21, 22, 23, 24],
                        [28, 29, 30, 31])


def hand_physics_rerank(mano: MANOModel, tables: anchor_lib.ForceAnchorTables, pose,
                        root_joint_flip, obj_vert, obj_com, force_local, k: int) -> Dict:
    """Per-finger physics re-rank of the distal/tip parameters over (B, C, 58) candidates."""
    B, C = pose.shape[:2]
    vert, _ = hand_verts_meters(mano, pose[..., :48], pose[..., 48:])
    vert_cam = vert + root_joint_flip[:, None, None]
    fl = force_local[:, None].expand(B, C, 32, 3)
    force_point, force_global = anchor_lib.force_local_to_global(tables, fl, vert_cam)
    force_norm = torch.linalg.norm(force_global, dim=-1)                 # (B, C, 32)
    force_weight = force_norm / (force_norm.sum(-1, keepdim=True) + 1e-12)
    dist, _ = min_dist_and_idx(force_point.contiguous(), obj_vert.contiguous())
    force_dir = force_global / (force_norm[..., None] + 1e-12)
    moment = torch.linalg.norm(force_dir.sum(-2), dim=-1)                # (B, C)
    score = -(force_weight * dist * moment[..., None])

    fuse_pose = pose[:, 0].clone()
    for f, anchors in enumerate(FINGER_ANCHOR_LEVELS):
        _, topk = top_k(score[:, :, anchors].sum(-1), k)
        fuse_idx = (MANO_PARAMS_LEVEL[2][3 * f:3 * f + 3]
                    + MANO_PARAMS_LEVEL[3][3 * f:3 * f + 3])
        sel = take_candidates(pose[..., :48], topk)[:, :, fuse_idx].reshape(B, k, 2, 3)
        quat = T.axis_angle_to_quaternion(sel).transpose(1, 2)           # (B, 2, K, 4)
        fuse_pose[:, fuse_idx] = T.quaternion_to_axis_angle(
            T.average_quaternion(quat)).reshape(B, 6)
    fuse_vert, fuse_joint = hand_verts_meters(mano, fuse_pose[:, :48], fuse_pose[:, 48:])
    return {"agg_pose": fuse_pose, "agg_vert": fuse_vert, "agg_joint": fuse_joint}


def _add_root(pose6d: torch.Tensor, root_joint: torch.Tensor) -> torch.Tensor:
    """Wrist-relative (..., 9) poses -> camera frame: root added to the translation."""
    root = root_joint.reshape(root_joint.shape[0], *([1] * (pose6d.dim() - 2)), 3)
    return torch.cat([pose6d[..., :6], pose6d[..., 6:] + root], dim=-1)


def obj_topk_by_heatmap(registry: YCBRegistry, pose6d, root_joint, obj_ids, is_right,
                        cam_intrinsic, heatmap, bbox, k: int):
    """Rank (B, N, 9) object candidates by bicubic heat at their projected keypoints."""
    pt3d = heads.object_transform(registry, _add_root(pose6d, root_joint), obj_ids, "keypoint")
    pt3d = heads.flip_pt3d(pt3d, is_right)
    pt2d = normalize_pt2d_to_bbox(T.project_points_batched(pt3d, cam_intrinsic), bbox)
    val, topk = top_k(sample_points(heatmap, pt2d, mode="bicubic").sum(-1), k)
    return topk, (val + 1e-8) / (val.sum(1, keepdim=True) + 1e-8)


def obj_fuse_topk(pose6d, topk, weight=None):
    """Weighted translation mean + eigh-averaged rotation of the selected candidates."""
    sel = take_candidates(pose6d, topk)
    if weight is None:
        trans = sel[..., 6:].mean(1)
    else:
        trans = (sel[..., 6:] * weight[..., None]).sum(1)
    return torch.cat([T.average_rot6d(sel[..., :6], weight), trans], dim=-1)


def obj_topk_by_physics3(registry: YCBRegistry, pose6d, root_joint, obj_ids, is_right,
                         force_point, force_global, k: int, arm_mode: str = "reference"):
    """Force-weighted point-to-surface distance x net-moment ranking.  ``arm_mode``
    "reference" keeps the reference's moment arm ``(force_point - nearest) - CoM``; "surface"
    uses ``nearest - CoM`` (DEVIATIONS.md D14)."""
    pose_cam = _add_root(pose6d, root_joint)
    obj_com = heads.flip_pt3d(heads.object_transform(registry, pose_cam, obj_ids, "CoM"),
                              is_right)                                  # (B, N, 1, 3)
    fnorm = torch.linalg.norm(force_global, dim=-1)                      # (B, 32)
    fweight = fnorm / (fnorm.sum(-1, keepdim=True) + 1e-12)
    B = pose_cam.shape[0]
    rotmat = T.rotation_6d_to_matrix(pose_cam[..., :6])                  # (B, N, 3, 3)
    trans = pose_cam[..., 6:]
    verts = heads.object_points(registry, obj_ids, "verts")              # (B, V, 3)
    fp_flip = T.flip_point3d(force_point, ~is_right)
    # distances are isometry-invariant: search in each candidate's canonical frame
    fp_local = (fp_flip[:, None] - trans[:, :, None]) @ rotmat           # (B, N, 32, 3)
    dist, idx = min_dist_and_idx(fp_local.contiguous(), verts.contiguous())
    near_canon = verts[torch.arange(B, device=verts.device)[:, None, None], idx.long()]
    near = near_canon @ rotmat.transpose(-1, -2) + trans[:, :, None]
    near = heads.flip_pt3d(near, is_right)
    score = (dist * fweight[:, None]).sum(-1)                            # (B, N)
    fdir = force_global / (fnorm[..., None] + 1e-12)
    r = (force_point[:, None] - near) if arm_mode == "reference" else near
    r = r - obj_com
    moment = torch.linalg.norm(torch.linalg.cross(fdir[:, None].expand_as(r), r, dim=-1)
                               .sum(-2), dim=-1)
    val, topk = top_k(-(score * moment), k)
    return topk, torch.ones_like(val) / k


def hoi_aggregate(mano: MANOModel, registry: YCBRegistry,
                  tables: anchor_lib.ForceAnchorTables, *, cam_intrinsic, root_joint_flip,
                  root_joint, is_right, force_local, is_grasped, hand_pose_diff,
                  hand_pose_regression, hand_shape, hand_heatmap, hand_bbox, hand_topk: int,
                  obj_pose6d, obj_heatmap, obj_bbox, obj_topk: int, obj_ids,
                  phy_topk: int = 5, is_weight: bool = True,
                  use_regression_as_candidate: bool = True,
                  do_physics_selection: bool = True) -> Dict[str, torch.Tensor]:
    """The 5-stage orchestration with the three CLI flags live."""
    B = root_joint.shape[0]
    # stage 4 ranks obj_topk^2 candidates and stage 5 hand_topk + 1: clamp the re-rank k
    phy_topk = min(phy_topk, obj_topk * obj_topk, hand_topk + 1)

    # 1. hand heatmap cascade
    hand_sel = hand_heatmap_cascade(
        mano, hand_pose_diff, hand_pose_regression, hand_shape, root_joint_flip,
        cam_intrinsic, hand_heatmap, hand_bbox, hand_topk, is_weight=is_weight,
        use_regression_as_candidate=use_regression_as_candidate)
    agg_hand_mano = hand_sel["agg_hand_mano"]
    force_point, force_global = anchor_lib.force_local_to_global(
        tables, force_local, hand_sel["agg_vert"] + root_joint_flip[:, None])

    common = dict(registry=registry, root_joint=root_joint, obj_ids=obj_ids,
                  is_right=is_right, cam_intrinsic=cam_intrinsic, heatmap=obj_heatmap,
                  bbox=obj_bbox)
    # 2. object translation top-k by heatmap
    transl_topk, transl_weight = obj_topk_by_heatmap(pose6d=obj_pose6d, k=obj_topk, **common)
    fused_trans = obj_fuse_topk(obj_pose6d, transl_topk,
                                transl_weight if is_weight else None)[:, 6:]

    # 3. rotation top-k with the fused translation substituted
    updated = torch.cat([obj_pose6d[..., :6], fused_trans[:, None].expand_as(obj_pose6d[..., 6:])],
                        dim=-1)
    rot_topk, _ = obj_topk_by_heatmap(pose6d=updated, k=obj_topk, **common)

    # 4. k x k cross-product candidates, physics vs heatmap re-rank
    k = obj_topk
    cand_transl = take_candidates(obj_pose6d, transl_topk)[..., 6:]      # (B, k, 3)
    cand_rot = take_candidates(obj_pose6d, rot_topk)[..., :6]            # (B, k, 6)
    cand = torch.cat([cand_rot[:, None].expand(B, k, k, 6),
                      cand_transl[:, :, None].expand(B, k, k, 3)], dim=-1).reshape(B, k * k, 9)
    topk_hm, weight_hm = obj_topk_by_heatmap(pose6d=cand, k=phy_topk, **common)
    if do_physics_selection:
        topk_phy, weight_phy = obj_topk_by_physics3(
            registry, cand, root_joint, obj_ids, is_right, force_point, force_global, phy_topk)
        grasped = is_grasped.bool()[:, None]
        new_topk = torch.where(grasped, topk_phy, topk_hm)
        new_weight = torch.where(grasped, weight_phy, weight_hm)
    else:
        new_topk, new_weight = topk_hm, weight_hm
    obj_agg_6d = obj_fuse_topk(cand, new_topk, new_weight if is_weight else None)

    pose_cam = _add_root(obj_agg_6d, root_joint)
    obj_vert_fused = heads.flip_pt3d(
        heads.object_transform(registry, pose_cam, obj_ids, "verts"), is_right)
    obj_com_fused = heads.flip_pt3d(
        heads.object_transform(registry, pose_cam, obj_ids, "CoM"), is_right)
    if not do_physics_selection:
        return {"obj_agg_6d": obj_agg_6d, "agg_obj_vert": obj_vert_fused,
                "hand_agg_mano": agg_hand_mano, "hand_agg_vert": hand_sel["agg_vert"],
                "hand_agg_joint": hand_sel["agg_joint"]}

    # 5. per-finger physics re-rank over distal/tip level candidates
    lvl2, lvl3 = MANO_PARAMS_LEVEL[2], MANO_PARAMS_LEVEL[3]
    level4 = hand_sel["middle_data"][3].topk_idx_pose_aa[:, :hand_topk]  # (B, K, 5, 3)
    agg_l3 = agg_hand_mano[:, lvl2].reshape(B, 1, 5, 3)
    agg_l4 = agg_hand_mano[:, lvl3].reshape(B, 1, 5, 3)
    level4 = torch.cat([level4, agg_l4], dim=1)                          # (B, K+1, 5, 3)
    n_cand = hand_topk + 1
    new_pose = agg_hand_mano[:, None, :48].expand(B, n_cand, 48).clone()
    new_pose[:, :, lvl2] = agg_l3.expand(B, n_cand, 5, 3).reshape(B, n_cand, 15)
    new_pose[:, :, lvl3] = level4.reshape(B, n_cand, 15)
    new_cand = torch.cat([new_pose, agg_hand_mano[:, None, 48:].expand(B, n_cand, 10)], dim=-1)
    hand_final = hand_physics_rerank(mano, tables, new_cand, root_joint_flip, obj_vert_fused,
                                     obj_com_fused, force_local, phy_topk)
    return {"obj_agg_6d": obj_agg_6d, "agg_obj_vert": obj_vert_fused,
            "hand_agg_mano": hand_final["agg_pose"], "hand_agg_vert": hand_final["agg_vert"],
            "hand_agg_joint": hand_final["agg_joint"]}


def obj_heatmap_cascade(registry: YCBRegistry, pose6d, root_joint, obj_ids, is_right,
                        cam_intrinsic, heatmap, bbox, k: int, is_weight: bool = True,
                        force_selection: bool = False, force_point=None, force_global=None,
                        is_grasped=None, phy_topk: int = 5) -> Dict:
    """Standalone object cascade: trans1 -> rot1 -> trans2 | rot1, then either the k x k
    physics (grasped) / heatmap re-rank (``force_selection``) or a plain trans2 + rot2 fuse.
    The rot2 stage scores exactly the rot1 candidates, so its selection is rot1's."""
    B = pose6d.shape[0]
    common = dict(registry=registry, root_joint=root_joint, obj_ids=obj_ids, is_right=is_right,
                  cam_intrinsic=cam_intrinsic, heatmap=heatmap, bbox=bbox)
    topk, w = obj_topk_by_heatmap(pose6d=pose6d, k=k, **common)
    fused_trans1 = obj_fuse_topk(pose6d, topk, w if is_weight else None)[:, 6:]
    p_rot1 = torch.cat([pose6d[..., :6], fused_trans1[:, None].expand_as(pose6d[..., 6:])], -1)
    topk_r2, w = obj_topk_by_heatmap(pose6d=p_rot1, k=k, **common)
    fused_rot1 = obj_fuse_topk(p_rot1, topk_r2, w if is_weight else None)[:, :6]
    p_trans2 = torch.cat([fused_rot1[:, None].expand_as(pose6d[..., :6]), pose6d[..., 6:]], -1)
    topk_t2, _ = obj_topk_by_heatmap(pose6d=p_trans2, k=k, **common)

    if force_selection:
        if force_point is None or force_global is None or is_grasped is None:
            raise ValueError("force selection needs force_point, force_global and is_grasped")
        phy_topk = min(phy_topk, k * k)
        trans2 = take_candidates(p_trans2, topk_t2)[..., 6:]                  # (B, k, 3)
        rot2 = take_candidates(p_rot1, topk_r2)[..., :6]                      # (B, k, 6)
        cand = torch.cat([rot2[:, :, None].expand(B, k, k, 6),
                          trans2[:, None].expand(B, k, k, 3)], dim=-1).reshape(B, k * k, 9)
        topk_p, _ = obj_topk_by_physics3(registry, cand, root_joint, obj_ids, is_right,
                                         force_point, force_global, phy_topk)
        topk_h, _ = obj_topk_by_heatmap(pose6d=cand, k=phy_topk, **common)
        new_topk = torch.where(is_grasped.bool()[:, None], topk_p, topk_h)
        fused = obj_fuse_topk(cand, new_topk)                                # unweighted
    else:
        # both final fuses are unweighted whatever is_weight says, as in the reference
        fused = torch.cat([obj_fuse_topk(p_rot1, topk_r2)[:, :6],
                           obj_fuse_topk(p_trans2, topk_t2)[:, 6:]], dim=-1)
    return _obj_result(registry, fused, root_joint, obj_ids, is_right, pose6d)


def obj_select_by_2d_pt(registry: YCBRegistry, pose6d, root_joint, obj_ids, is_right,
                        cam_intrinsic, heatmap, bbox, k: int) -> Dict:
    """Rank by the distance of projected keypoints to the heatmap peaks; unweighted fuse."""
    pt3d = heads.flip_pt3d(heads.object_transform(registry, _add_root(pose6d, root_joint),
                                                  obj_ids, "keypoint"), is_right)
    pt2d = normalize_pt2d_to_bbox(T.project_points_batched(pt3d, cam_intrinsic), bbox)
    score = -torch.linalg.norm(pt2d - _heatmap_peaks(heatmap)[:, None], dim=-1).sum(-1)
    _, topk = top_k(score, k)
    return _obj_result(registry, obj_fuse_topk(pose6d, topk), root_joint, obj_ids, is_right,
                       pose6d)


def _obj_result(registry: YCBRegistry, fused, root_joint, obj_ids, is_right, candidates) -> Dict:
    vert = heads.flip_pt3d(heads.object_transform(registry, _add_root(fused, root_joint),
                                                  obj_ids, "verts"), is_right)
    return {"agg_6d": fused, "candidate_6d": candidates, "agg_obj_vert": vert}


def aggregate_obj(mode: str, registry: YCBRegistry, **kw) -> Dict:
    """``--aggregation_mode_obj`` dispatch over the standalone object aggregators."""
    pose6d = kw["pose6d"]
    common = (pose6d, kw["root_joint"], kw["obj_ids"], kw["is_right"])
    if mode == "heatmap_cascade":
        return obj_heatmap_cascade(
            registry, *common, kw["cam_intrinsic"], kw["heatmap"], kw["bbox"], kw["k"],
            is_weight=kw.get("is_weight", True),
            force_selection=kw.get("force_selection", False),
            force_point=kw.get("force_point"), force_global=kw.get("force_global"),
            is_grasped=kw.get("is_grasped"))
    if mode == "heatmap":
        topk, weight = obj_topk_by_heatmap(registry, *common, kw["cam_intrinsic"], kw["heatmap"],
                                           kw["bbox"], kw["k"])
        fused = obj_fuse_topk(pose6d, topk, weight if kw.get("is_weight", True) else None)
    elif mode == "2D_pt_pose":
        return obj_select_by_2d_pt(registry, *common, kw["cam_intrinsic"], kw["heatmap"],
                                   kw["bbox"], kw["k"])
    elif mode == "average_all":
        B, N = pose6d.shape[:2]
        n = min(kw["k"], N)
        fused = obj_fuse_topk(pose6d, torch.arange(n, device=pose6d.device)[None].expand(B, n))
    elif mode == "random":
        fused = obj_fuse_topk(pose6d, pose6d.new_zeros((pose6d.shape[0], 1), dtype=torch.long))
    else:
        raise NotImplementedError(mode)
    return _obj_result(registry, fused, kw["root_joint"], kw["obj_ids"], kw["is_right"], pose6d)
