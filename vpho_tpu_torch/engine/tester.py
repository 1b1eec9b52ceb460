"""TesterHand / TesterObject: metric accumulation and report formatting (counterpart of
``vpho_tpu/engine/tester.py``).

``add_batch`` computes the batch's criteria where its tensors live and keeps them there, so
the eval loop waits on no metric; ``result()`` moves the rows to the host.  Reports follow
the reference: per YCB class without '051_large_clamp', 'average_instance' /
'average_class', distances truncated to 0.01 mm and rates to 0.01 %; hand splits right /
left / both plus per-joint MJE.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from ..models.ycb import YCBRegistry
from . import metrics as M

DIST_KEYS = ("MCE", "MCE2", "SMCE", "OCE", "ADD", "ADDS", "CD")
RATE_KEYS = ("ADD01d", "ADDS01d", "REP5")


def _tensor(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x) if device is None else torch.as_tensor(x, device=device)
    return t.float() if t.is_floating_point() else t


def _valid_column(valid, n: int, device) -> torch.Tensor:
    if valid is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return torch.as_tensor(np.asarray(valid, bool) if not isinstance(valid, torch.Tensor)
                           else valid, device=device).bool()


class _Rows:
    """Per-batch metric rows; the valid mask stays a column, filtered in ``_cat``."""

    def __init__(self):
        self._rows: list[dict] = []

    def gather_rows(self):
        """Pool every process's rows before reporting: the identity for one process."""

    def _cat(self) -> Dict[str, np.ndarray]:
        cat = {k: torch.cat([r[k] for r in self._rows]).cpu().numpy() for k in self._rows[0]}
        keep = cat.pop("_valid").astype(bool)
        return {k: v[keep] for k, v in cat.items()}


class TesterHand(_Rows):
    """Accumulates per-batch hand criteria; reports mm tables."""

    def add_batch(self, gt_joint, pd_joint, gt_vert, pd_vert, is_right, valid=None):
        pd_joint = _tensor(pd_joint)
        dev = pd_joint.device
        out = M.hand_metrics(_tensor(gt_joint, dev), pd_joint, _tensor(gt_vert, dev),
                             _tensor(pd_vert, dev))
        out["is_right"] = _tensor(is_right, dev).bool()
        out["_valid"] = _valid_column(valid, out["is_right"].shape[0], dev)
        self._rows.append(out)

    def result(self) -> Dict[str, Dict[str, float]]:
        if not self._rows:
            return {}
        cat = self._cat()
        is_right = cat.pop("is_right").astype(bool)
        splits = {"right": is_right, "left": ~is_right, "both": np.ones_like(is_right)}
        res: Dict[str, Dict[str, float]] = {}
        for key in ("MJE", "PA_MJE", "MVE", "PAMVE"):
            res[key] = {s: float(cat[key][m].mean()) if m.any() else float("nan")
                        for s, m in splits.items()}
        for j in range(21):
            res[f"MJE_{j}"] = {s: float(cat["JE"][m][:, j].mean()) if m.any() else float("nan")
                               for s, m in splits.items()}
        return res

    def report_mm(self) -> Dict[str, Dict[str, str]]:
        return {k: {s: f"{1000 * v:.2f}" for s, v in d.items()}
                for k, d in self.result().items()}


class TesterObject(_Rows):
    """Accumulates per-batch object criteria on the registry's device; per-class reports."""

    def __init__(self, registry: YCBRegistry):
        super().__init__()
        self.registry = registry

    def add_batch(self, pd_rt, gt_rt, obj_ids, cam_intr, valid=None):
        dev = self.registry.kpt3d.device
        ids = _tensor(obj_ids, dev)
        out = M.object_metrics(self.registry, _tensor(pd_rt, dev), _tensor(gt_rt, dev), ids,
                               _tensor(cam_intr, dev))
        out["obj_id"] = ids
        out["_valid"] = _valid_column(valid, ids.shape[0], dev)
        self._rows.append(out)

    def result(self) -> Dict[str, Dict[str, float]]:
        if not self._rows:
            return {}
        cat = self._cat()
        obj_id = cat.pop("obj_id")
        res: Dict[str, Dict[str, float]] = {}
        for key in sorted(cat):                  # the reference's report lists them sorted
            vals, per, class_vals = cat[key], {}, []
            for i, name in enumerate(self.registry.names):
                if name == "051_large_clamp":            # excluded, as in the reference
                    continue
                sel = obj_id == i
                if sel.any():
                    per[name] = float(vals[sel].mean())
                    class_vals.append(vals[sel])
            if class_vals:
                allv = np.concatenate(class_vals)
                per["average_class"] = per["average_instance"] = float(allv.mean())
            else:
                per["average_class"] = per["average_instance"] = float("nan")
            res[key] = per
        return res

    def report(self) -> Dict[str, Dict[str, float]]:
        """Truncating format: distances in mm, rates in percent, REP in pixels."""
        out = {}
        for key, per in self.result().items():
            fmt = {}
            for name, v in per.items():
                if not np.isfinite(v):
                    fmt[name] = v
                elif key in DIST_KEYS:
                    fmt[name] = int(v * 100000) / 100
                elif key in RATE_KEYS or key.startswith("FSCORE@"):
                    fmt[name] = int(v * 10000) / 100
                elif key == "REP":
                    fmt[name] = int(v * 100) / 100
                else:
                    fmt[name] = v
            out[key] = fmt
        return out


def evaluate_prediction_pkl(path: str, registry: YCBRegistry):
    """Re-score a dumped ``my-prediction_align-*.pkl``: its rows carry pd_obj_rt, gt_obj_rt
    and obj_id; returns the TesterObject report.  The dump holds no camera, so REP and REP5
    use a nominal K and are reported under a marked name."""
    with open(path, "rb") as f:
        rows = pickle.load(f)
    t_obj = TesterObject(registry)
    nominal_k = False
    for r in rows:
        n = r["pd_obj_rt"].shape[0]
        K = np.tile(np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32),
                    (n, 1, 1))
        nominal_k = nominal_k or "cam_intr" not in r
        t_obj.add_batch(r["pd_obj_rt"], r["gt_obj_rt"], r["obj_id"], r.get("cam_intr", K))
    report = t_obj.report()
    if nominal_k:
        for key in ("REP", "REP5"):
            if key in report:
                report[f"{key} (nominal-K!)"] = report.pop(key)
    return report
