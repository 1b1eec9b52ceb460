"""Config system: the full flag surface of the reference CLI (counterpart of
``vpho_tpu/configs/config.py``).

Same flag names, defaults, ``choices`` and ``store_false`` booleans as the JAX parser
(``--do_weighted_average`` / ``--do_physics_selection`` / ``--use_regression_as_candidate``
DISABLE the feature when passed), and the same strict unknown-key validation.  Configs are
built explicitly and passed down; ``cfg.to_model_config()`` extracts the port's
``ModelConfig``.  The device is not a flag: entry points take it as an argument.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Tuple

from ..models.vpho import ModelConfig


@dataclasses.dataclass
class Config:
    # run meta (args.py:124-127)
    mode: str = "train"
    eval_full: bool = False
    eval_path: str = ""
    mark: str = ""
    # training (args.py:130-146)
    random_seed: int = 0
    gradient_accumulation_steps: int = 1
    gradient_clip: float = -1.0
    max_epochs: int = 100
    output_dir: str = "output"
    optimizer: str = "adamw"
    base_learning_rate: float = 2e-4
    scheduler: str = "exp"
    gamma: float = 0.96
    lr_step: int = 5
    checkpoint: str = ""
    pretrain: str = ""
    remove_pretrained_keys: List[str] = dataclasses.field(default_factory=list)
    start_with_eval: bool = False
    print_freq: int = 500
    viz_freq: int = 50
    full_evaluation_freq: int = 10
    use_mix_trainset: bool = False
    # dataset (args.py:149-162)
    dataset_name: str = "dexycb"
    data_dir: str = "data/DexYCB"
    clean_data_mode: str = "2023_CVPR_HFL"
    bbox_scale_factor: float = 1.2
    patch_size: int = 256
    batch_size: int = 64
    eval_batch_size: int = 32
    num_workers: int = 16
    eval_num_workers: int = 8
    # fuse crop/color/normalize/erase/heatmaps into the device graph; the
    # loader ships decoded frames + warp/aug params (data/device_pipeline.py)
    device_preprocess: bool = False
    # augmentation (args.py:165-186)
    center_jittering: float = 0.2
    scale_factor: float = 0.2
    max_rot: float = 30.0
    rot_prob: float = 1.0
    clahe_prob: float = 0.5
    RGB_shift_prob: float = 0.5
    shift_limit: Tuple[float, float] = (-20, 20)
    color_jitter_prob: float = 0.5
    brightness: Tuple[float, float] = (0.6, 1.3)
    contrast: Tuple[float, float] = (0.6, 1.3)
    saturation: Tuple[float, float] = (0.6, 1.3)
    hue: Tuple[float, float] = (-0.15, 0.15)
    gaussian_blur_prob: float = 0.5
    blur_limit: Tuple[float, float] = (3, 7)
    sigma_limit: Tuple[float, float] = (0.2, 2.0)
    motion_blur_prob: float = 0.5
    motion_blur_limit: Tuple[float, float] = (3, 7)
    random_erasing_prob: float = 0.5
    random_erasing_mode: str = "pixel"
    random_erasing_min_area: float = 0.02
    random_erasing_max_area: float = 0.2
    random_erasing_max_count: int = 2
    # model (args.py:189-200)
    model: str = "vpho_net"
    sde_mode: str = "ve"
    repeat_num: int = 20
    sampler: str = "ode"
    sampling_steps: int = 500
    eval_repeat_num: int = 50
    heatmap_size: int = 64
    heatmap_hand_sigma: float = 2.0
    heatmap_obj_sigma: float = 2.0
    roi_size: int = 32
    # contact labeling band (args.py:44-45; Config-only fields, no CLI flag
    # in the reference either)
    contact_normal_distance_thresh: tuple = (-0.01, 0.01)
    contact_vertical_distance_thresh: float = 0.005
    # loss weights (args.py:203-223)
    weight_diff_hand_loss: float = 1.0
    weight_diff_obj_loss: float = 1.0
    weight_hm_hand_loss: float = 1e3
    weight_hm_obj_loss: float = 1e3
    weight_segm_obj_loss: float = 3e1
    weight_vert_loss: float = 1e4
    weight_joint_loss: float = 1e4
    weight_mano_pose_loss: float = 10.0
    weight_mano_shape_loss: float = 1.0
    weight_hand_contact_loss: float = 1.0
    weight_force_loss: float = 1.0
    weight_gravity_loss: float = 1.0
    weight_torque_loss: float = 30.0
    weight_distrib_loss: float = 1.0
    weight_supervised_loss: float = 10.0
    weight_point_loss: float = 1e2
    weight_CoM_loss: float = 1e2
    weight_joint2hm_loss: float = 1e3
    weight_obj_reg_vert_loss: float = 1e4
    weight_obj_reg_kpt_loss: float = 1e4
    weight_obj_reg_rot6d_loss: float = 10.0
    weight_obj_reg_trans_loss: float = 1e4
    # sample (args.py:227-230)
    sample_T0: float = 0.65
    sample_num: int = 50
    topk_hand: int = 15
    topk_obj: int = 5
    # aggregation (args.py:233-246)
    do_weighted_average: bool = True
    do_physics_selection: bool = True
    aggregation_mode_hand: str = "heatmap_cascade"
    aggregation_mode_obj: str = "heatmap_cascade"
    use_regression_as_candidate: bool = True
    # extras of the JAX package (not in the reference CLI)
    ode_method: str = "dpm3m"  # promotion rationale: ModelConfig.ode_method
    ode_schedule: str = "uniform"  # 'karras' available; study: docs/PERF.md r3
    compute_dtype: str = "float32"
    # when set, capture ONE trace of a steady-state (post-warmup) eval batch into this
    # directory (torch.profiler Chrome trace)
    trace_dir: str = ""
    # dominant-eigenvector solve inside quaternion averaging: eigh | power
    # (repeated squaring; see utils/transforms.py)
    quat_mean_impl: str = "eigh"
    # "batch" replicates the reference's batch-axis cross-module attention
    # for faithful reference-checkpoint inference (DEVIATIONS.md D1)
    cross_attention_axis: str = "tokens"
    num_devices: int = 0  # 0 = all visible
    mano_root: str = ""
    models_dir: str = ""
    # local stand-in for the reference's torchvision ImageNet model-zoo init
    # (backbone_FPN_HFL.py:256-261); loaded when the file exists
    imagenet_pretrain: str = "asset/resnet50.pth"

    def to_model_config(self) -> ModelConfig:
        """The predict knobs of the port's ``ModelConfig``."""
        return ModelConfig(**{f.name: getattr(self, f.name)
                              for f in dataclasses.fields(ModelConfig)})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Hand-Object Pose Estimation (PyTorch/CUDA)")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval", "infer", "infer_candidate",
                            "energy"])
    p.add_argument("--eval_full", action="store_true")
    p.add_argument("--eval_path", type=str, default="")
    p.add_argument("--mark", type=str, default="")
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_clip", type=float, default=-1.0)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw", "adam"])
    p.add_argument("--base_learning_rate", type=float, default=2e-4)
    p.add_argument("--scheduler", type=str, default="exp", choices=["exp", "cosine", "step"])
    p.add_argument("--gamma", type=float, default=0.96)
    p.add_argument("--lr_step", type=int, default=5)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--pretrain", type=str, default="")
    p.add_argument("--remove_pretrained_keys", nargs="+", default=[])
    p.add_argument("--start_with_eval", action="store_true")
    p.add_argument("--print_freq", type=int, default=500)
    p.add_argument("--viz_freq", type=int, default=50)
    p.add_argument("--full_evaluation_freq", type=int, default=10)
    p.add_argument("--dataset_name", type=str, default="dexycb", choices=["dexycb", "ho3d"])
    p.add_argument("--data_dir", type=str, default="data/DexYCB")
    p.add_argument("--clean_data_mode", type=str, default="2023_CVPR_HFL",
                   choices=["2023_CVPR_HFL", "2022_CVPR_ArtiBoost", "2023_WACV_DMA",
                            "stable_grasping", "2023_NIPS_DeepSimHO"])
    p.add_argument("--bbox_scale_factor", type=float, default=1.2)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--device_preprocess", action="store_true")
    p.add_argument("--eval_num_workers", type=int, default=8)
    p.add_argument("--use_mix_trainset", action="store_true")
    p.add_argument("--center_jittering", type=float, default=0.2)
    p.add_argument("--scale_factor", type=float, default=0.2)
    p.add_argument("--max_rot", type=float, default=30)
    p.add_argument("--rot_prob", type=float, default=1)
    p.add_argument("--clahe_prob", type=float, default=0.5)
    p.add_argument("--RGB_shift_prob", type=float, default=0.5)
    p.add_argument("--shift_limit", type=float, nargs=2, default=(-20, 20))
    p.add_argument("--color_jitter_prob", type=float, default=0.5)
    p.add_argument("--brightness", type=float, nargs=2, default=(0.6, 1.3))
    p.add_argument("--contrast", type=float, nargs=2, default=(0.6, 1.3))
    p.add_argument("--saturation", type=float, nargs=2, default=(0.6, 1.3))
    p.add_argument("--hue", type=float, nargs=2, default=(-0.15, 0.15))
    p.add_argument("--gaussian_blur_prob", type=float, default=0.5)
    p.add_argument("--blur_limit", type=float, nargs=2, default=(3, 7))
    p.add_argument("--sigma_limit", type=float, nargs=2, default=(0.2, 2.0))
    p.add_argument("--motion_blur_prob", type=float, default=0.5)
    p.add_argument("--motion_blur_limit", type=float, nargs=2, default=(3, 7))
    p.add_argument("--random_erasing_prob", type=float, default=0.5)
    p.add_argument("--random_erasing_mode", type=str, default="pixel")
    p.add_argument("--random_erasing_min_area", type=float, default=0.02)
    p.add_argument("--random_erasing_max_area", type=float, default=0.2)
    p.add_argument("--random_erasing_max_count", type=int, default=2)
    p.add_argument("--model", type=str, default="vpho_net", choices=["vpho_net"])
    p.add_argument("--sde_mode", type=str, default="ve", choices=["edm", "ve", "vp", "subvp"])
    p.add_argument("--repeat_num", type=int, default=20)
    p.add_argument("--sampler", type=str, default="ode", choices=["ode"])
    p.add_argument("--sampling_steps", type=int, default=500)
    p.add_argument("--eval_repeat_num", type=int, default=50)
    p.add_argument("--heatmap_size", type=int, default=64)
    p.add_argument("--heatmap_hand_sigma", type=float, default=2.0)
    p.add_argument("--heatmap_obj_sigma", type=float, default=2.0)
    p.add_argument("--roi_size", type=int, default=32)
    for name, default in [
        ("diff_hand_loss", 1.0), ("diff_obj_loss", 1.0), ("hm_hand_loss", 1e3),
        ("hm_obj_loss", 1e3), ("segm_obj_loss", 3e1), ("vert_loss", 1e4),
        ("joint_loss", 1e4), ("mano_pose_loss", 10.0), ("mano_shape_loss", 1.0),
        ("hand_contact_loss", 1.0), ("force_loss", 1.0), ("gravity_loss", 1.0),
        ("torque_loss", 30.0), ("distrib_loss", 1.0), ("supervised_loss", 10.0),
        ("point_loss", 1e2), ("CoM_loss", 1e2), ("joint2hm_loss", 1e3),
        ("obj_reg_vert_loss", 1e4), ("obj_reg_kpt_loss", 1e4),
        ("obj_reg_rot6d_loss", 10.0), ("obj_reg_trans_loss", 1e4),
    ]:
        p.add_argument(f"--weight_{name}", type=float, default=default)
    p.add_argument("--sample_T0", type=float, default=0.65)
    p.add_argument("--sample_num", type=int, default=50)
    p.add_argument("--topk_hand", type=int, default=15)
    p.add_argument("--topk_obj", type=int, default=5)
    # store_false semantics preserved from the reference (args.py:233-246)
    p.add_argument("--do_weighted_average", action="store_false")
    p.add_argument("--do_physics_selection", action="store_false")
    p.add_argument("--aggregation_mode_hand", type=str, default="heatmap_cascade",
                   choices=["heatmap_cascade", "heatmap", "2D_pt_pose", "2D_pt_joint",
                            "average_all", "random"])
    p.add_argument("--aggregation_mode_obj", type=str, default="heatmap_cascade",
                   choices=["heatmap_cascade", "heatmap", "2D_pt_pose",
                            "average_all", "random"])
    p.add_argument("--use_regression_as_candidate", action="store_false")
    # extras of the JAX package
    p.add_argument("--ode_method", type=str, default="dpm3m",
                   choices=["rk4", "heun", "euler", "dpm2m", "dpm3m"])
    p.add_argument("--ode_schedule", type=str, default="uniform",
                   choices=["uniform", "karras"])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trace_dir", type=str, default="")
    p.add_argument("--quat_mean_impl", type=str, default="eigh",
                   choices=["eigh", "power"])
    p.add_argument("--cross_attention_axis", type=str, default="tokens",
                   choices=["tokens", "batch"])
    p.add_argument("--num_devices", type=int, default=0)
    p.add_argument("--mano_root", type=str, default="")
    p.add_argument("--models_dir", type=str, default="")
    p.add_argument("--imagenet_pretrain", type=str, default="asset/resnet50.pth")
    return p


def get_config(argv=None) -> Config:
    """Parse argv into a validated Config (strict unknown-key check,
    args.py:256-260 semantics)."""
    args = build_parser().parse_args(argv)
    cfg = Config()
    valid = {f.name for f in dataclasses.fields(Config)}
    for k, v in vars(args).items():
        if k not in valid:
            raise ValueError(f"Invalid config key: {k}")
        setattr(cfg, k, tuple(v) if isinstance(v, list) and k not in
                ("remove_pretrained_keys",) else v)
    return cfg
