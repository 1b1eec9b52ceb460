"""Evaluation engine: the eval half of ``vpho_tpu/engine/trainer.py``.

``Trainer(cfg, device)`` builds the constants and, in ``init_state``, the model (seeded
weights, then ``--pretrain``).  ``evaluate`` runs the predict path and the metric suite over an
eval stream, ``dump_predictions`` writes the prediction pkl and ``infer_candidates`` dumps the
raw hypothesis sets.  Batches are host (numpy) dicts; a background thread stages the next one
on the device while the current one runs.  Host keys: ``_valid`` masks padded tail samples
out of the metrics and the dump, ``_index`` (with ``path_of``) fills the dump's index and path
columns.  The ODE start state of batch i is ``x0_for(i, batch_size)`` when given, else a draw
from a ``torch.Generator`` seeded 128 + i on the device.

The metrics stay on the device until the report; each batch makes one host transfer, for the
prediction dump.  Training, orbax checkpoints and multi-device evaluation are later slices.
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import sys
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..configs.config import Config
from ..data.prefetch import DeviceStager, prefetch
from ..models import anchor as anchor_lib
from ..models import vpho as V
from ..utils import transforms as T
from ..utils.platform import resolve_device
from . import viz
from .profiling import flops_of, param_count, trace
from .tester import TesterHand, TesterObject

X0Fn = Callable[[int, int], torch.Tensor]


def setup_logger(save_dir: str, name: str = "vpho_torch") -> logging.Logger:
    """File (``<save_dir>/info.log``) and console logging."""
    os.makedirs(save_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(os.path.join(save_dir, "info.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def postprocess_obj_rt(pose9d: torch.Tensor, root_joint: torch.Tensor) -> torch.Tensor:
    """Wrist-relative (B, ..., 9) pose -> camera-frame (B, ..., 3, 4) rt."""
    rt = T.obj_9d_to_mat(pose9d)
    root = root_joint.reshape((root_joint.shape[0],) + (1,) * (rt.dim() - 3) + (3,))
    return torch.cat([rt[..., :3], rt[..., 3:] + root[..., None]], dim=-1)


def postprocess_hand_vert(vert: torch.Tensor, root_joint: torch.Tensor,
                          is_right: torch.Tensor) -> torch.Tensor:
    """Unflip left hands and move from wrist-relative to the camera frame."""
    vert = T.flip_point3d(vert, ~is_right)
    return vert + root_joint.reshape((root_joint.shape[0],) + (1,) * (vert.dim() - 2) + (3,))


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy for 4-byte tensors: packed as int32 words, split on the host."""
    flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1) for t in tensors.values()])
    words = flat.cpu().numpy()
    out, at = {}, 0
    for k, t in tensors.items():
        n = t.numel()
        out[k] = words[at:at + n].view(np.float32 if t.is_floating_point() else np.int32
                                       ).reshape(tuple(t.shape))
        at += n
    return out


def _filter_rows(rows, path_of):
    """Drop padded samples; turn the ``_index`` column into ``index`` (and ``path``)."""
    filtered = []
    for r in rows:
        keep = np.asarray(r.pop("_valid"), bool)
        idx = np.asarray(r.pop("_index"))[keep]
        row = {k: np.asarray(v)[keep] for k, v in r.items()}
        if (idx >= 0).all():
            row["index"] = idx
            if path_of is not None:
                row["path"] = [path_of(int(j)) for j in idx]
        filtered.append(row)
    return filtered


def format_table(table: Dict[str, Dict[str, Any]]) -> str:
    """A {row: {column: value}} report as aligned text, one line per row."""
    cols = list(dict.fromkeys(c for row in table.values() for c in row))
    cells = [[""] + cols] + [[str(k)] + [str(row.get(c, "")) for c in cols]
                             for k, row in table.items()]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cols) + 1)]
    return "\n".join("  ".join(c.rjust(w) for c, w in zip(r, widths)) for r in cells)


class _BatchClock:
    """Per-batch spans without host waits: CUDA events on the stream (device timeline) on a
    GPU, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    @staticmethod
    def seconds(a, b) -> float:
        return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


class Trainer:
    """Evaluation / inference runner (the eval half of the JAX package's ``Trainer``)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.num_devices > 1:
            raise NotImplementedError("--num_devices > 1 is not ported yet (ROADMAP section 1, "
                                      "training: multi-GPU via torch DDP)")
        if cfg.device_preprocess:
            raise NotImplementedError("--device_preprocess is not ported yet (ROADMAP section 1, "
                                      "data pipeline: the GPU preprocess)")
        if cfg.checkpoint:
            raise NotImplementedError("--checkpoint (orbax epoch_N.state) is not ported yet "
                                      "(ROADMAP section 1, training: checkpoints with resume)")
        T.set_quat_mean_impl(cfg.quat_mean_impl)
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.save_dir = os.path.join(cfg.output_dir,
                                     f"{stamp}_{cfg.mark}_{cfg.mode}_{cfg.model}")
        self.logger = setup_logger(self.save_dir)
        self.ctx = V.make_context(cfg.to_model_config(), cfg.mano_root or None,
                                  cfg.models_dir or None, device=self.device)
        self.tester_hand_keys = ("regression", "one_candidate", "agg_candidate")
        self.model: Optional[V.VPHONet] = None
        self._trace_done = False
        self._told_no_jpg = False
        self.last_eval: Optional[Dict[str, Any]] = None     # the latest evaluate()'s output

    # -- weights -----------------------------------------------------------------------

    def init_state(self):
        """The model with seeded weights (``--random_seed``, else 206), then ``--pretrain``."""
        cfg = self.cfg
        self.model = V.build_model(cfg.to_model_config(), seed=cfg.random_seed or 206,
                                   device=self.device,
                                   cross_attention_axis=cfg.cross_attention_axis)
        if cfg.imagenet_pretrain and os.path.exists(cfg.imagenet_pretrain):
            raise NotImplementedError(
                f"--imagenet_pretrain {cfg.imagenet_pretrain}: loading a torchvision resnet50 "
                f"is not ported yet (ROADMAP section 1, CLI and tooling)")
        if cfg.pretrain:
            from ..utils.weights import load_pretrain

            rep = load_pretrain(self.model, cfg.pretrain, cfg.remove_pretrained_keys)
            for k in rep["missing"]:
                self.logger.warning(f"pretrain: missing key {k}")
            self.logger.info(f"Loaded pretrain {cfg.pretrain}: {len(rep['loaded'])} tensors, "
                             f"{len(rep['missing'])} missing")
        self.logger.info(f"Model params: {param_count(self.model) / 1e6:.2f}M")

    # -- loops -------------------------------------------------------------------------

    def _x0(self, i: int, batch_size: int, x0_for: Optional[X0Fn]) -> torch.Tensor:
        if x0_for is not None:
            return torch.as_tensor(x0_for(i, batch_size), dtype=torch.float32,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(128 + i)
        return V.draw_x0(self.ctx, batch_size, gen)

    def _staged(self, batches: Iterable[Dict[str, Any]]):
        """(batch on the device, valid, index) per host batch, staged a batch ahead."""
        stager = DeviceStager(self.device)

        def stage(batch):
            batch = dict(batch)
            valid, index = batch.pop("_valid", None), batch.pop("_index", None)
            n = len(next(iter(batch.values())))
            valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
            index = np.full(n, -1) if index is None else np.asarray(index)
            return stager.stage(batch), valid, index

        for staged, valid, index in prefetch(batches, stage):
            yield stager.ready(staged), valid, index

    def _predict(self, i: int, batch, x0):
        """forward_predict; batch 0 also counts the graph's operations, batch 1 is traced
        when ``--trace_dir`` is set."""
        run = lambda: V.forward_predict(self.model, self.ctx, batch, x0=x0)
        if i == 0:
            pd, cost = flops_of(run)
            self.logger.info(f"predict graph: {cost['flops'] / 1e9:.2f} GFLOPs "
                             f"({cost['kernel_flops'] / 1e9:.2f} in the CUDA kernels), "
                             f"{param_count(self.model) / 1e6:.2f}M params")
            return pd
        if i == 1 and self.cfg.trace_dir and not self._trace_done:
            try:
                with trace(self.cfg.trace_dir) as tr:
                    pd = run()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                self._trace_done = True
                self.logger.info(f"trace written: {tr['path']}")
                return pd
            except OSError as e:              # the trace directory: the next evaluate() retries
                self.logger.warning(f"trace failed ({e}); will retry at the next evaluate()")
        return run()

    def evaluate(self, batches: Iterable[Dict[str, Any]], path_of=None,
                 x0_for: Optional[X0Fn] = None) -> Dict[str, Any]:
        """Predict + metric suite over an eval stream.  Each batch carries gt_joint and
        gt_hand_vert (camera frame), gt_obj_rt (3, 4), cam_intr and obj_id besides the model
        inputs.  Returns the report, the dump rows and the per-batch timing."""
        testers_hand = {k: TesterHand() for k in self.tester_hand_keys}
        testers_obj = {k: TesterObject(self.ctx.registry)
                       for k in ("one_candidate", "mean_candidate_pose")}
        collector_res = []
        clock = _BatchClock(self.device)
        timing = {"predict_s": [], "metrics_s": [], "batch_s": [], "frames": []}
        t_prev = time.perf_counter()
        with torch.inference_mode():
            for i, (b, valid, index) in enumerate(self._staged(batches)):
                x0 = self._x0(i, b["rgb"].shape[0], x0_for)
                m0 = clock.mark()
                pd = self._predict(i, b, x0)
                m1 = clock.mark()
                root, is_right = b["root_joint"], b["is_right"].bool()
                hv = lambda v: postprocess_hand_vert(v, root, is_right)
                pd_vert_agg, pd_joint_agg = hv(pd["agg_hand_vert"]), hv(pd["agg_hand_joint"])
                pd_rt_agg = postprocess_obj_rt(pd["agg_obj_6d"], root)
                hand_preds = {
                    "regression": (hv(pd["reg_hand_joint"]), hv(pd["reg_hand_vert"])),
                    "one_candidate": (hv(pd["diff_final_hand_joint"][:, 0]),
                                      hv(pd["diff_final_hand_vert"][:, 0])),
                    "agg_candidate": (pd_joint_agg, pd_vert_agg)}
                for key, (pj, pv) in hand_preds.items():
                    testers_hand[key].add_batch(b["gt_joint"], pj, b["gt_hand_vert"], pv,
                                                is_right, valid)
                obj_preds = {
                    "one_candidate": postprocess_obj_rt(pd["diff_final_obj_6d"][:, 0], root),
                    "mean_candidate_pose": pd_rt_agg}
                for key, rt in obj_preds.items():
                    testers_obj[key].add_batch(rt, b["gt_obj_rt"], b["obj_id"], b["cam_intr"],
                                               valid)
                m2 = clock.mark()
                row = _host({"pd_obj_rt": pd_rt_agg, "pd_hand_vert": pd_vert_agg,
                             "pd_hand_joint": pd_joint_agg, "gt_obj_rt": b["gt_obj_rt"],
                             "obj_id": b["obj_id"].int()})
                row["pd_hand_vert"] = row["pd_hand_vert"].astype(np.float16)
                collector_res.append({**row, "_valid": valid, "_index": index})
                if self.cfg.viz_freq > 0 and i % self.cfg.viz_freq == 0:
                    self._viz(i, b, pd, pd_vert_agg, pd_rt_agg)
                t_now = time.perf_counter()
                timing["predict_s"].append(clock.seconds(m0, m1))
                timing["metrics_s"].append(clock.seconds(m1, m2))
                timing["batch_s"].append(t_now - t_prev)
                timing["frames"].append(int(valid.sum()))
                t_prev = t_now

        if self.cfg.trace_dir and not self._trace_done:
            self.logger.warning("--trace_dir set but no trace captured: the capture runs on "
                                "the second eval batch and this stream had fewer than 2")
        for t in list(testers_hand.values()) + list(testers_obj.values()):
            t.gather_rows()
        report = {"hand": {k: t.report_mm() for k, t in testers_hand.items()},
                  "object": {k: t.report() for k, t in testers_obj.items()}}
        for group, per in report.items():
            for variant, table in per.items():
                self.logger.info(f"{group}/{variant}:\n" + format_table(table))
        self.last_eval = {"report": report,
                          "collector_res": _filter_rows(collector_res, path_of), "timing": timing}
        return self.last_eval

    def _viz(self, i: int, b, pd, pd_vert_agg, pd_rt_agg):
        """Batch3D pkl dumps of sample 0, and the heatmap JPGs when cv2 is installed."""
        np0 = lambda t: t[0].float().cpu().numpy()
        root, is_right = b["root_joint"], b["is_right"].bool()
        obj_id0 = int(b["obj_id"][0])
        verts0 = self.ctx.registry.verts_sampled[obj_id0].cpu().numpy()
        gt_rt0 = np0(b["gt_obj_rt"])
        rt0 = np0(pd_rt_agg)
        viz.save_viz_hand(
            self.save_dir, i, gt_vert=np0(b["gt_hand_vert"]),
            gt_obj_vert=verts0 @ gt_rt0[:, :3].T + gt_rt0[:, 3],
            pd_vert_reg=np0(postprocess_hand_vert(pd["reg_hand_vert"], root, is_right)),
            pd_vert_diff=np0(postprocess_hand_vert(pd["diff_final_hand_vert"], root, is_right)),
            pd_vert_agg=np0(pd_vert_agg))
        viz.save_viz_obj(
            self.save_dir, i, self.ctx.registry, obj_id0, gt_rt=gt_rt0,
            pd_rt_cands=np0(postprocess_obj_rt(pd["diff_final_obj_6d"], root)),
            pd_rt_agg=rt0, gt_hand=np0(b["gt_hand_vert"]))
        if viz.jpg_writer_available():
            viz.save_viz_heatmap(
                self.save_dir, i, rgb_norm=np0(b["rgb"]), bbox_hand=np0(b["bbox_hand"]),
                bbox_obj=np0(b["bbox_obj"]), pd_hm_hand=np0(pd["hand_heatmap"]),
                gt_hm_hand=np0(b["hm_hand"] if "hm_hand" in b else pd["hand_heatmap"]),
                pd_hm_obj=np0(pd["obj_heatmap"]),
                gt_hm_obj=np0(b["hm_obj"] if "hm_obj" in b else pd["obj_heatmap"]))
            if "obj_segm" in pd and "segm_obj" in b:
                viz.save_viz_segmentation(
                    self.save_dir, i, rgb_norm=np0(b["rgb"]), bbox_obj=np0(b["bbox_obj"]),
                    pd_obj_segm=np0(pd["obj_segm"])[0], gt_obj_segm=np0(b["segm_obj"])[0])
        elif not self._told_no_jpg:
            self.logger.info("cv2 is not installed: the heatmap JPGs are not written")
            self._told_no_jpg = True
        # anchor frames live on the flipped (right-hand) mesh, as in the aggregation
        vert_flip0 = pd["agg_hand_vert"][:1] + b["root_joint_flip"][:1, None]
        fp, fg = anchor_lib.force_local_to_global(self.ctx.anchor_tables,
                                                  pd["force_local"][:1], vert_flip0)
        com0 = self.ctx.registry.com[obj_id0].cpu().numpy()[None]
        viz.save_viz_force(
            self.save_dir, i, vert=np0(vert_flip0), force_point=np0(fp), force_global=np0(fg),
            gravity=np0(b["gravity"]), com=com0 @ rt0[:, :3].T + rt0[:, 3],
            obj_mesh=verts0 @ rt0[:, :3].T + rt0[:, 3])

    def dump_predictions(self, collector_res, tag: str = "") -> str:
        """The my-prediction pkl."""
        path = os.path.join(self.save_dir,
                            f"my-prediction_align-{self.cfg.clean_data_mode}{tag}.pkl")
        with open(path, "wb") as f:
            pickle.dump(collector_res, f)
        self.logger.info(f"Dumped predictions: {path}")
        return path

    def infer_candidates(self, batches: Iterable[Dict[str, Any]], path_of=None,
                         x0_for: Optional[X0Fn] = None) -> str:
        """``--mode infer_candidate``: per frame, the S diffusion candidates (hand MANO 58-d,
        object 9-d), the regression joints and the physics cue, without aggregation (fp16
        where bulky).  Returns the pkl path."""
        rows = []
        with torch.inference_mode():
            for i, (b, valid, index) in enumerate(self._staged(batches)):
                x0 = self._x0(i, b["rgb"].shape[0], x0_for)
                pd, _ = V.forward_candidates(self.model, self.ctx, b, x0=x0)
                row = _host({"diff_hand_mano": pd["diff_final_hand_mano"],
                             "diff_obj_6d": pd["diff_final_obj_6d"],
                             "reg_hand_joint": pd["reg_hand_joint"],
                             "force_local": pd["force_local"],
                             "is_grasped": b["is_grasped"].float(), "obj_id": b["obj_id"].int()})
                for k in ("diff_hand_mano", "reg_hand_joint", "force_local"):
                    row[k] = row[k].astype(np.float16)
                rows.append({**row, "_valid": valid, "_index": index})
        path = os.path.join(self.save_dir,
                            f"my-candidates_align-{self.cfg.clean_data_mode}.pkl")
        with open(path, "wb") as f:
            pickle.dump(_filter_rows(rows, path_of), f)
        self.logger.info(f"Dumped candidates: {path}")
        return path
