"""vpho_net on torch: the trunk, the joint hand+object ODE and the 5-stage aggregation
(counterpart of ``vpho_tpu/models/vpho.py``).

  * ``VPHONet`` holds every trainable part under the reference torch key names, so weights
    carried across from the JAX package (``utils/weights.py``) load with ``strict=True``.
  * ``VPHOContext`` carries the constants: MANO, the YCB registry, the anchor tables, the SDE,
    the config and the device.
  * ``forward_predict`` = ``forward_candidates`` (trunk -> one 105-d probability-flow ODE over
    B*S hypotheses -> MANO FK) + ``hoi_aggregate``.

The public layouts are the JAX package's: ``rgb`` enters as NHWC (B, H, W, 3) and heatmaps
leave as (B, J, H, W); inside, feature maps are NCHW.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch
import torch.nn as nn

from ..diffusion.sampler import ode_sampler
from ..diffusion.sde import SDE, init_sde
from ..ops.image import resample_rectilinear, resize_bilinear, roi_align
from ..utils import transforms as T
from ..utils.platform import resolve_device
from . import aggregation as agg
from . import anchor as anchor_lib
from . import heads
from .backbone import FPNBackbone
from .denoiser import Denoiser
from .layers import Encoder, HeadHeatmap, MultiheadAttention
from .mano import MANOModel, hand_verts_meters, load_mano
from .ycb import YCBRegistry, load_registry

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The architecture and predict knobs of the JAX ``ModelConfig``."""

    roi_size: int = 32
    heatmap_size: int = 64
    patch_size: int = 256
    sde_mode: str = "ve"
    sampling_steps: int = 50
    sample_T0: float = 0.65
    sample_num: int = 50
    topk_hand: int = 15
    topk_obj: int = 5
    ode_method: str = "dpm3m"
    ode_schedule: str = "uniform"
    compute_dtype: str = "float32"     # "bfloat16" for the bf16 policy
    aggregation_mode_hand: str = "heatmap_cascade"
    aggregation_mode_obj: str = "heatmap_cascade"
    do_weighted_average: bool = True
    do_physics_selection: bool = True
    use_regression_as_candidate: bool = True


class VPHOContext(NamedTuple):
    mano: MANOModel
    registry: YCBRegistry
    anchor_tables: anchor_lib.ForceAnchorTables
    sde: SDE
    cfg: ModelConfig
    device: torch.device


def make_context(cfg: ModelConfig | None = None, mano_root: str | None = None,
                 models_dir: str | None = None, device=None) -> VPHOContext:
    """Constants on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    mano = load_mano(mano_root, device=dev)
    return VPHOContext(mano=mano, registry=load_registry(models_dir, device=dev),
                       anchor_tables=anchor_lib.load_anchor_tables(mano, device=dev),
                       sde=init_sde(cfg.sde_mode), cfg=cfg, device=dev)


class VPHONet(nn.Module):
    """All trainable modules of vpho_net.  ``compute_dtype`` None (f32) or ``torch.bfloat16``
    for the conv trunk, encoders, cross modules and the denoiser banks."""

    def __init__(self, roi_size: int = 32, heatmap_size: int = 64, compute_dtype=None,
                 cross_attention_axis: str = "tokens"):
        super().__init__()
        d = compute_dtype
        self.roi_size, self.heatmap_size = roi_size, heatmap_size
        self.feature_extractor = FPNBackbone(compute_dtype=d)
        self.head_hm_hand = HeadHeatmap(256, 21, compute_dtype=d)
        self.head_hm_obj = HeadHeatmap(256, 27, compute_dtype=d)
        self.encoder_hand = Encoder(256 + 21, 256, compute_dtype=d)
        self.encoder_obj = Encoder(256 + 27, 256, compute_dtype=d)
        self.head_mano = heads.HeadMano()
        spatial = (roi_size // 4) ** 2
        self.cross_hand = heads.CrossModule(256, 512, spatial=spatial,
                                            attention_axis=cross_attention_axis, compute_dtype=d)
        self.cross_obj = heads.CrossModule(256, 512, spatial=spatial,
                                           attention_axis=cross_attention_axis, compute_dtype=d)
        self.head_physics = heads.HeadPhysics(512)
        self.denoiser_hand = Denoiser("mano_pose", compute_dtype=d)
        self.denoiser_obj = Denoiser("obj", compute_dtype=d)

    def align_hm_to_bbox_rectangle(self, hm, bbox, bbox_rect):
        """Resample a tight-bbox heatmap (B, J, S, S) onto the rectangular-bbox frame."""
        S = self.heatmap_size
        coords = (torch.arange(S, dtype=hm.dtype, device=hm.device) / (S - 1)) * 2.0 - 1.0
        rel = (bbox_rect[:, 2:] - bbox_rect[:, :2]) / (bbox[:, 2:] - bbox[:, :2])
        xs = ((coords[None] * rel[:, 0, None] + 1.0) * S - 1.0) / 2.0
        ys = ((coords[None] * rel[:, 1, None] + 1.0) * S - 1.0) / 2.0
        return resample_rectilinear(hm, xs, ys)

    def trunk(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """data: rgb (B, H, W, 3) normalized; bbox_* (B, 4) crop coords; is_right (B,) bool;
        gravity (B, 1, 3); obj_CoM (B, 1, 3)."""
        rgb = data["rgb"].permute(0, 3, 1, 2)
        hand_feat, obj_feat = self.feature_extractor(rgb)
        rs = self.roi_size
        hf_hr = roi_align(hand_feat, data["bbox_hand"], rs)
        hf_hr_rect = roi_align(hand_feat, data["bbox_hand_rect"], rs)
        of_or_rect = roi_align(obj_feat, data["bbox_obj_rect"], rs)

        pd_hm_hand = self.head_hm_hand(hf_hr)                          # (B, 21, H, W)
        pd_hm_obj = self.head_hm_obj(of_or_rect)                       # (B, 27, H, W)
        pd_hm_hand_rect = self.align_hm_to_bbox_rectangle(
            pd_hm_hand, data["bbox_hand"], data["bbox_hand_rect"])
        pd_hm_obj_rect = self.align_hm_to_bbox_rectangle(
            pd_hm_obj, data["bbox_obj"], data["bbox_obj_rect"])

        # object features / heatmaps back to the original chirality for left hands
        flip = (~data["is_right"])[:, None, None, None]
        of_or_rect = torch.where(flip, of_or_rect.flip(-1), of_or_rect)
        pd_hm_obj_rect = torch.where(flip, pd_hm_obj_rect.flip(-1), pd_hm_obj_rect)

        enc_in_hand = torch.cat([hf_hr_rect.float(), resize_bilinear(pd_hm_hand_rect, (rs, rs))], 1)
        enc_in_obj = torch.cat([of_or_rect.float(), resize_bilinear(pd_hm_obj_rect, (rs, rs))], 1)
        encoding_hand, enc_hand_ls = self.encoder_hand(enc_in_hand)
        encoding_obj, enc_obj_ls = self.encoder_obj(enc_in_obj)
        encoding_hand, encoding_obj = encoding_hand.float(), encoding_obj.float()
        enc_hand_1, enc_obj_1 = enc_hand_ls[1].float(), enc_obj_ls[1].float()

        pd_mano_pose, pd_mano_shape = self.head_mano(encoding_hand)
        gravity_f = T.flip_point3d(data["gravity"], ~data["is_right"])
        obj_com_f = T.flip_point3d(data["obj_CoM"], ~data["is_right"])
        enc_phy_hand = self.cross_hand(enc_hand_1, enc_obj_1, gravity_f)[0]
        enc_phy_obj = self.cross_obj(enc_hand_1, enc_obj_1, gravity_f)[1]
        return {
            "encoding_hand": encoding_hand,
            "encoding_obj": encoding_obj,
            "pd_hm_hand": pd_hm_hand,
            "pd_hm_obj": pd_hm_obj,
            "pd_mano_pose": pd_mano_pose,
            "pd_mano_shape": pd_mano_shape,
            "pd_phy": self.head_physics(enc_phy_hand, enc_phy_obj),
            "gravity_flipped": gravity_f,
            "obj_CoM_flipped": obj_com_f,
        }


def init_vpho_weights(model: VPHONet, generator: torch.Generator) -> VPHONet:
    """Random weights in the JAX package's init scheme, drawn from ``generator`` (a CPU
    generator; call before moving the model).  The denoisers' last bank layer starts at zero,
    as in the reference."""
    init = nn.init

    def trunc(t, scale, fan):
        s = math.sqrt(scale / fan) / 0.87962566103423978
        init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=generator)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                fan_out = w.shape[0] * w[0, 0].numel() if w.dim() == 4 else w.shape[0]
                if name.startswith("feature_extractor.layer"):
                    trunc(w, 2.0, fan_out)
                elif name.startswith("feature_extractor") or ".attn." in name:
                    trunc(w, 1.0, fan_in)
                elif name.startswith("cross_"):
                    init.normal_(w, 0.0, math.sqrt(2.0 / fan_in), generator=generator)
                elif name.startswith(("head_hm", "encoder")):
                    init.normal_(w, 0.0, 0.001, generator=generator)
                else:
                    init.normal_(w, 0.0, 0.01, generator=generator)
                if m.bias is not None:
                    init.zeros_(m.bias)
            elif isinstance(m, MultiheadAttention):
                trunc(m.in_proj_weight, 1.0, m.in_proj_weight.shape[1])
                init.zeros_(m.in_proj_bias)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                init.ones_(m.weight)
                init.zeros_(m.bias)
        for den in (model.denoiser_hand, model.denoiser_obj):
            den.t_encoder[0].W.normal_(0.0, 30.0, generator=generator)
            l1, l2 = den.head.head[0], den.head.head[2]
            bound = 1.0 / math.sqrt(l1.weight.shape[1])
            l1.weight.uniform_(-bound, bound, generator=generator)
            l1.bias.uniform_(-bound, bound, generator=generator)
            init.zeros_(l2.weight)
            init.zeros_(l2.bias)
    return model


def postprocess_diffusion_hand(final_6d: torch.Tensor, shape: torch.Tensor,
                               sample_num: int) -> torch.Tensor:
    """rot6d ODE output (B*S, 96) -> (B, S, 58) MANO params with the regressed shape."""
    B = shape.shape[0]
    f = final_6d.reshape(B, sample_num, 16, 6)
    aa = T.matrix_to_axis_angle(T.rotation_6d_to_matrix(f)).reshape(B, sample_num, 48)
    return torch.cat([aa, shape[:, None].expand(B, sample_num, 10)], dim=-1)


def _score_fn(denoiser: Denoiser, sde: SDE, feat: torch.Tensor):
    """(x, t) -> score closure; the conditioning projection, and K1's constant operands where
    the head runs as K1, are computed once per forward."""
    feat_proj = denoiser.precompute_feat(feat)
    fused = denoiser.head.prepare_fused(feat_proj) if denoiser.head.runs_k1 else None

    def fn(x: torch.Tensor, t: float) -> torch.Tensor:
        t_arr = torch.full((1, 1), t, dtype=torch.float32, device=x.device)
        return denoiser.score_from_proj(feat_proj, x, t_arr, float(sde.marginal_prob(None, t)[1]),
                                        fused)

    return fn


def draw_x0(ctx: VPHOContext, batch_size: int, generator: torch.Generator | None = None):
    """The ODE start state: (B*S, 105) standard normal draws times the prior std at T0."""
    cfg = ctx.cfg
    z = torch.randn((batch_size * cfg.sample_num, 96 + 9), generator=generator,
                    device=generator.device if generator is not None else ctx.device)
    return z.to(ctx.device) * ctx.sde.prior_std(cfg.sample_T0)


@torch.inference_mode()
def forward_candidates(model: VPHONet, ctx: VPHOContext, batch: Dict[str, torch.Tensor],
                       x0: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       return_trajectory: bool = False):
    """Trunk + joint hand/object ODE over B*S hypotheses, without aggregation.
    Returns ``(pd_dt, trunk_out)``.  ``x0`` (B*S, 105) is the start state; when absent it is
    drawn from ``generator``.  ``return_trajectory`` adds the ODE states at every grid point
    as ``diff_inprocess_hand_6d`` (B, S, steps, 96) and ``diff_inprocess_obj_6d``."""
    cfg = ctx.cfg
    S = cfg.sample_num
    out = model.trunk(batch)
    B = batch["rgb"].shape[0]
    pd_dt: Dict[str, torch.Tensor] = {}
    pd_dt["reg_hand_vert"], pd_dt["reg_hand_joint"] = hand_verts_meters(
        ctx.mano, out["pd_mano_pose"], out["pd_mano_shape"])
    pd_dt["hand_heatmap"] = out["pd_hm_hand"]
    pd_dt["obj_heatmap"] = out["pd_hm_obj"]
    pd_dt["force_local"] = out["pd_phy"]["force_local"]

    score_h = _score_fn(model.denoiser_hand, ctx.sde, out["encoding_hand"])
    score_o = _score_fn(model.denoiser_obj, ctx.sde, out["encoding_obj"])

    def score_both(x, t):
        return torch.cat([score_h(x[:, :96], t), score_o(x[:, 96:], t)], dim=-1)

    if x0 is None:
        x0 = draw_x0(ctx, B, generator)
    final = ode_sampler(score_both, x0.to(ctx.device, torch.float32), ctx.sde, cfg.sample_T0,
                        cfg.sampling_steps, method=cfg.ode_method, schedule=cfg.ode_schedule,
                        return_trajectory=return_trajectory)
    if return_trajectory:
        traj, final = final
        pd_dt["diff_inprocess_hand_6d"] = traj[..., :96].reshape(B, S, -1, 96)
        pd_dt["diff_inprocess_obj_6d"] = traj[..., 96:].reshape(B, S, -1, 9)
    hand_mano = postprocess_diffusion_hand(final[:, :96], out["pd_mano_shape"], S)
    pd_dt["diff_final_hand_mano"] = hand_mano
    pd_dt["diff_final_hand_vert"], pd_dt["diff_final_hand_joint"] = hand_verts_meters(
        ctx.mano, hand_mano[..., :48], hand_mano[..., 48:])
    pd_dt["diff_final_obj_6d"] = final[:, 96:].reshape(B, S, 9)
    return pd_dt, out


@torch.inference_mode()
def forward_predict(model: VPHONet, ctx: VPHOContext, batch: Dict[str, torch.Tensor],
                    x0: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    return_trajectory: bool = False) -> Dict[str, torch.Tensor]:
    """The full predict path: candidates, then the aggregation."""
    pd_dt, out = forward_candidates(model, ctx, batch, x0=x0, generator=generator,
                                    return_trajectory=return_trajectory)
    return aggregate(ctx, batch, pd_dt, out)


@torch.inference_mode()
def aggregate(ctx: VPHOContext, batch: Dict[str, torch.Tensor], pd_dt: Dict[str, torch.Tensor],
              out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fuse ``forward_candidates``'s hypotheses (``pd_dt``, trunk output ``out``) into the
    ``agg_*`` entries of ``pd_dt``.  The default heatmap_cascade/heatmap_cascade pair runs the
    5-stage HOI orchestration; any other ``aggregation_mode_hand/obj`` pair runs the
    standalone aggregators."""
    cfg = ctx.cfg
    hand_mano = pd_dt["diff_final_hand_mano"]
    mode_h, mode_o = cfg.aggregation_mode_hand, cfg.aggregation_mode_obj
    if (mode_h, mode_o) == ("heatmap_cascade", "heatmap_cascade"):
        hoi = agg.hoi_aggregate(
            ctx.mano, ctx.registry, ctx.anchor_tables,
            cam_intrinsic=batch["cam_intr_crop_flip"],
            root_joint_flip=batch["root_joint_flip"],
            root_joint=batch["root_joint"],
            is_right=batch["is_right"],
            force_local=out["pd_phy"]["force_local"],
            is_grasped=batch["is_grasped"],
            hand_pose_diff=hand_mano[..., :48],
            hand_pose_regression=out["pd_mano_pose"],
            hand_shape=hand_mano[..., 48:],
            hand_heatmap=out["pd_hm_hand"],
            hand_bbox=batch["bbox_hand"],
            hand_topk=cfg.topk_hand,
            obj_pose6d=pd_dt["diff_final_obj_6d"],
            obj_heatmap=out["pd_hm_obj"],
            obj_bbox=batch["bbox_obj_rect"],
            obj_topk=cfg.topk_obj,
            obj_ids=batch["obj_id"],
            is_weight=cfg.do_weighted_average,
            use_regression_as_candidate=cfg.use_regression_as_candidate,
            do_physics_selection=cfg.do_physics_selection,
        )
        pd_dt["agg_obj_6d"] = hoi["obj_agg_6d"]
        pd_dt["agg_hand_mano"] = hoi["hand_agg_mano"]
        pd_dt["agg_hand_vert"] = hoi["hand_agg_vert"]
        pd_dt["agg_hand_joint"] = hoi["hand_agg_joint"]
        return pd_dt

    hand_res = agg.aggregate_hand(
        mode_h, ctx.mano, pose=hand_mano[..., :48], shape=hand_mano[..., 48:],
        pose_regression=out["pd_mano_pose"], root_joint=batch["root_joint_flip"],
        cam_intrinsic=batch["cam_intr_crop_flip"], heatmap=out["pd_hm_hand"],
        bbox=batch["bbox_hand"], k=cfg.topk_hand, is_weight=cfg.do_weighted_average,
        use_regression_as_candidate=cfg.use_regression_as_candidate)
    # the object cascade's force selection needs anchors on the aggregated hand
    force_point, force_global = anchor_lib.force_local_to_global(
        ctx.anchor_tables, out["pd_phy"]["force_local"],
        hand_res["agg_vert"] + batch["root_joint_flip"][:, None])
    obj_res = agg.aggregate_obj(
        mode_o, ctx.registry, pose6d=pd_dt["diff_final_obj_6d"], root_joint=batch["root_joint"],
        obj_ids=batch["obj_id"], is_right=batch["is_right"],
        cam_intrinsic=batch["cam_intr_crop_flip"], heatmap=out["pd_hm_obj"],
        bbox=batch["bbox_obj_rect"], k=cfg.topk_obj, is_weight=cfg.do_weighted_average,
        force_selection=cfg.do_physics_selection, force_point=force_point,
        force_global=force_global, is_grasped=batch["is_grasped"])
    pd_dt["agg_obj_6d"] = obj_res["agg_6d"]
    pd_dt["agg_hand_mano"] = hand_res["agg_hand_mano"]
    pd_dt["agg_hand_vert"] = hand_res["agg_vert"]
    pd_dt["agg_hand_joint"] = hand_res["agg_joint"]
    return pd_dt


def build_model(cfg: ModelConfig, seed: int = 0, device=None,
                cross_attention_axis: str = "tokens") -> VPHONet:
    """A VPHONet for ``cfg`` with seeded random weights, in eval mode on ``device``."""
    model = VPHONet(cfg.roi_size, cfg.heatmap_size, _DTYPES[cfg.compute_dtype],
                    cross_attention_axis)
    init_vpho_weights(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()
