"""The comparison that decides ``correct``: the reference's answers, worked out again from the
benchmark's own weights and inputs, against what the timed path produced.

Eval cells: ``drivers/eval_loop.py::reference_answers`` runs the reference's
``forward_predict`` and metrics on every pool batch that the window drove (or a seeded sample
of them), at the window's batch size; ``eval_numbers`` takes, for each window row, the gap
between the program's aggregated hand joints and object pose and the reference's, and compares
the median frame's hand gap, the share of frames whose hand gap is far (over ``HAND_FAR_MM``)
and a low quantile of the object's gap: the aggregation's top-k choices are discontinuous, and
the hand ODE amplifies the bf16 rounding in which K1 and its plain form differ, so a share of
frames flips to another choice in any sound run and the widest gap swings from seed to seed.
A sound run moves few hands far, so a fault on a part of each batch's rows raises the far share
before it moves the median; the object's choice flips on up to about half of the frames (the
reference does so against itself, with its start state one ulp away), so its gap is held at
the median frame over a batch of 64 and at the 25th percentile over 64 single frames.  It also compares the report's
unaggregated entries with the same report worked out from the reference's rows over the
window's frames.

Training cell: ``reference_train`` follows the program's first three steps from the same
weights, batches and draws (each step's draws from a generator seeded 1000 + its epoch, as
``Trainer.train_one_epoch`` takes them); ``train_numbers`` compares the first two steps'
losses, the first gradient (the program's from Adam's first moment after one replayed step),
leaf by leaf, and the worst and the median leaf's change after three steps (parameters and
batch-norm statistics): the third step's loss swings from seed to seed, because Adam's first
updates move each element whose gradient is near zero by about the learning rate whatever its
rounding, so it is reported beside the compared numbers, not compared.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference.vpho_ref.engine import metrics as RM
from .reference.vpho_ref.engine.post import postprocess_hand_vert, postprocess_obj_rt
from .reference.vpho_ref.models import vpho as RV
from .reference.vpho_ref.models.layers import DropoutMasks

HAND_VARIANTS = ("regression", "one_candidate", "agg_candidate")
OBJ_VARIANTS = ("one_candidate", "mean_candidate_pose")
HAND_KEYS = ("MJE", "PA_MJE", "MVE", "PAMVE")
OBJ_KEYS = ("MCE", "ADD", "ADDS", "CD")           # distances, reported in mm
HAND_FAR_MM, OBJ_FAR_MM = 50.0, 1.0              # a frame's gap that counts it as far
BOX = torch.tensor([[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)])


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``, floats as float32, without the host-only columns."""
    out = {}
    for k, v in arrays.items():
        if k.startswith("_"):
            continue
        v = np.asarray(v)
        out[k] = torch.as_tensor(v.astype(np.float32) if v.dtype.kind == "f" else v,
                                 device=device)
    return out


def reference_model(state_dict: Dict[str, torch.Tensor], compute_dtype: str, device):
    """The reference VPHONet with the benchmark's weights, in eval mode."""
    with torch.device("meta"):
        model = RV.VPHONet(compute_dtype=RV._DTYPES[compute_dtype])
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def reference_context(model_cfg: Dict, device) -> RV.VPHOContext:
    return RV.make_context(RV.ModelConfig(**model_cfg), device=device)


@torch.inference_mode()
def reference_eval(model, ctx, batch: Dict[str, torch.Tensor], x0: torch.Tensor) -> Dict:
    """One batch's answers and metric rows, as the eval loop makes them."""
    pd = RV.forward_predict(model, ctx, batch, x0=x0)
    root, is_right = batch["root_joint"], batch["is_right"].bool()
    hv = lambda v: postprocess_hand_vert(v, root, is_right)
    hands = {"regression": (hv(pd["reg_hand_joint"]), hv(pd["reg_hand_vert"])),
             "one_candidate": (hv(pd["diff_final_hand_joint"][:, 0]),
                               hv(pd["diff_final_hand_vert"][:, 0])),
             "agg_candidate": (hv(pd["agg_hand_joint"]), hv(pd["agg_hand_vert"]))}
    objs = {"one_candidate": postprocess_obj_rt(pd["diff_final_obj_6d"][:, 0], root),
            "mean_candidate_pose": postprocess_obj_rt(pd["agg_obj_6d"], root)}
    rows = {}
    for k, (pj, pv) in hands.items():
        m = RM.hand_metrics(batch["gt_joint"], pj, batch["gt_hand_vert"], pv)
        rows.update({f"hand/{k}/{key}": m[key] for key in HAND_KEYS})
    for k, rt in objs.items():
        m = RM.object_metrics(ctx.registry, rt, batch["gt_obj_rt"], batch["obj_id"],
                              batch["cam_intr"])
        rows.update({f"object/{k}/{key}": m[key] for key in OBJ_KEYS})
    return {"joint": hands["agg_candidate"][0].float().cpu(),
            "obj_rt": objs["mean_candidate_pose"].float().cpu(),
            "rows": {k: v.double().cpu() for k, v in rows.items()}}


def box_gap_mm(rt_a: torch.Tensor, rt_b: torch.Tensor) -> torch.Tensor:
    """(N, 3, 4) poses -> (N,) the largest displacement of a 20 cm box's corners, in mm."""
    box = BOX.to(rt_a)
    pa = box @ rt_a[..., :3].transpose(-1, -2) + rt_a[..., None, :, 3]
    pb = box @ rt_b[..., :3].transpose(-1, -2) + rt_b[..., None, :, 3]
    return 1e3 * torch.linalg.norm(pa - pb, dim=-1).amax(-1)


def report_numbers(report: Dict) -> Dict[str, float]:
    """The compared entries of an ``evaluate`` report: the hand tables' "both" split (mm) and
    the object tables' "average_instance" (mm)."""
    out = {}
    for k in HAND_VARIANTS:
        for key in HAND_KEYS:
            out[f"hand/{k}/{key}"] = float(report["hand"][k][key]["both"])
    for k in OBJ_VARIANTS:
        for key in OBJ_KEYS:
            out[f"object/{k}/{key}"] = float(report["object"][k][key]["average_instance"])
    return out


def expected_report(ref_rows: Dict[int, Dict[str, torch.Tensor]], frames: Sequence[tuple],
                    obj_ids: Dict[int, np.ndarray], excluded: Optional[int]) -> Dict[str, float]:
    """The report's entries over the window's ``frames`` ((pool batch, row) pairs, repeats
    counted) from the reference's per-frame rows, in mm; the object averages leave out the
    class the report leaves out (``excluded``)."""
    out = {}
    for name in ref_rows[next(iter(ref_rows))]:
        vals = np.array([float(ref_rows[k][name][r]) for k, r in frames])
        if name.startswith("object/") and excluded is not None:
            keep = np.array([int(obj_ids[k][r]) != excluded for k, r in frames])
            vals = vals[keep]
        out[name] = 1e3 * float(vals.mean())
    return out


def eval_numbers(rows: List[Dict[str, np.ndarray]], report: Optional[Dict[str, float]],
                 ref: Dict[int, Dict], batch_size: int, excluded: Optional[int],
                 obj_ids: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of an eval cell.  ``rows`` are the window's dump rows (their
    ``index`` gives the pool frame), ``report`` the program's report entries (None: not
    compared), ``ref`` the reference's answers by pool batch (a sample of the pool, or all)."""
    joint_gap, obj_gap, frames = [], [], []
    for r in rows:
        idx = np.asarray(r["index"])
        for j, i in enumerate(idx):
            k, row = int(i) // batch_size, int(i) % batch_size
            frames.append((k, row))
            if k not in ref:
                continue
            pj = torch.as_tensor(np.asarray(r["pd_hand_joint"][j], np.float32))
            gap = torch.linalg.norm(pj - ref[k]["joint"][row], dim=-1).max()
            joint_gap.append(1e3 * float(gap))
            prt = torch.as_tensor(np.asarray(r["pd_obj_rt"][j], np.float32))[None]
            obj_gap.append(float(box_gap_mm(prt, ref[k]["obj_rt"][row:row + 1])[0]))
    joint_gap, obj_gap = np.asarray(joint_gap), np.asarray(obj_gap)
    out = {"hand_joint_gap_p50_mm": float(np.percentile(joint_gap, 50)),
           "obj_pose_gap_p50_mm": float(np.percentile(obj_gap, 50)),
           "hand_far_share": float((joint_gap > HAND_FAR_MM).mean()),
           "obj_far_share": float((obj_gap > OBJ_FAR_MM).mean()),
           "frames_compared": float(len(joint_gap))}
    out.update({f"hand_far_share.{t}mm": float((joint_gap > t).mean()) for t in (20, 30)})
    out.update({f"obj_far_share.{t}mm": float((obj_gap > t).mean()) for t in (10, 100)})
    out["obj_pose_gap_p25_mm"] = float(np.percentile(obj_gap, 25))
    out.update({f"hand_joint_gap_p{q}_mm": float(np.percentile(joint_gap, q)) for q in (90, 100)})
    out.update({f"obj_pose_gap_p{q}_mm": float(np.percentile(obj_gap, q)) for q in (90, 100)})
    if report is not None:
        seen = [f for f in frames if f[0] in ref]
        expect = expected_report({k: v["rows"] for k, v in ref.items()}, seen, obj_ids,
                                 excluded)
        gaps = {n: abs(report[n] - expect[n]) / max(abs(expect[n]), 1.0) for n in expect}
        for group in ("hand/regression", "hand/one_candidate", "hand/agg_candidate",
                      "object/one_candidate", "object/mean_candidate_pose"):
            out[f"metric_gap.{group}"] = max(v for n, v in gaps.items() if n.startswith(group))
        out["metric_gap.unaggregated"] = max(out["metric_gap.hand/regression"],
                                             out["metric_gap.object/one_candidate"])
    return out


# -- training ------------------------------------------------------------------------------

B1, B2, EPS, DECAY = 0.9, 0.999, 1e-8, 1e-4


class AdamW:
    """optax's adamw chain as the training configuration states it: scale_by_adam (b1 0.9,
    b2 0.999, eps 1e-8), decoupled weight decay 1e-4, then -lr, in plain per-leaf torch; the
    bias corrections in float32 as optax computes them."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.lr, self.count = float(np.float32(lr)), 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).add_(g * g, alpha=1 - B2)
            u = (m / bc1) / ((v / bc2).sqrt() + EPS) + DECAY * p
            p.add_(u, alpha=-self.lr)


def reference_train(model, ctx, batches: Sequence[Dict[str, torch.Tensor]], lr: float,
                    half_batch: bool = False) -> Dict:
    """The reference's first steps from ``model``'s weights, one batch a step, step k's
    draws from a device generator seeded 1000 + k.  Returns each step's losses, the first
    step's gradients and the parameters and statistics after the last step.  ``half_batch``
    plants a fault: each step sees its batch's first half, the mean taken over those rows."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = AdamW(params, lr)
    losses, grad1 = [], None
    for k, batch in enumerate(batches):
        gen = torch.Generator(device=ctx.device).manual_seed(1000 + k)
        rows = None
        if half_batch:
            n = int(batch["rgb"].shape[0])
            batch = {key: v[: n // 2] for key, v in batch.items()}
            rows = (0, n // 2, n)
        total, weighted = RV.forward_train(model, ctx, batch, dropout=DropoutMasks(
            generator=gen, rows=rows), generator=gen, rows=rows)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if grad1 is None:
            grad1 = {n: float(torch.linalg.vector_norm(g.double())) for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append({key: float(v.detach()) for key, v in weighted.items()})
    state = {n: t.detach().clone() for n, t in model.state_dict().items()
             if t.is_floating_point()}
    return {"losses": losses, "grad1": grad1, "state": state}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> tuple:
    """The largest |prog - ref| over leaves, each against max(ref leaf, median ref leaf)."""
    med = float(np.median(list(ref.values())))
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def change_norms(state: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each floating leaf's distance from where it started (parameters and batch-norm
    statistics)."""
    return {n: float(torch.linalg.vector_norm((t.detach() - start[n]).double()))
            for n, t in state.items() if t.is_floating_point()}


def train_numbers(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor]) -> Dict:
    """``prog`` holds the program's losses, first gradient's leaf norms (from Adam's first
    moment) and ``change`` (``change_norms`` after its third step); ``ref`` is what
    ``reference_train`` returns; ``start`` the weights both began from.  The change leaves
    out the parameters whose first reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone under Adam.  Each leaf's gap is against the larger of
    its reference norm and the median leaf's."""
    loss_gaps = []
    for lp, lr in zip(prog["losses"], ref["losses"]):
        med = float(np.median([abs(v) for v in lr.values()]))
        loss_gaps.append(max(abs(lp[k] - lr[k]) / max(abs(lr[k]), med, 1e-30) for k in lr))
    grad_gap, grad_leaf = _worst_leaf(prog["grad1"], ref["grad1"])
    med_grad = float(np.median(list(ref["grad1"].values())))
    ref_change = change_norms(ref["state"], start)
    moved = [n for n in ref_change if n not in ref["grad1"] or ref["grad1"][n] >= 1e-3 * med_grad]
    prog_moved, ref_moved = ({n: c[n] for n in moved} for c in (prog["change"], ref_change))
    change_gap, change_leaf = _worst_leaf(prog_moved, ref_moved)
    med = float(np.median(list(ref_moved.values())))
    median_leaf = float(np.median([abs(prog_moved[n] - ref_moved[n]) / max(ref_moved[n], med)
                                   for n in moved]))
    out = {f"loss_gap.step{k + 1}": g for k, g in enumerate(loss_gaps)}
    return {**out, "grad_gap": grad_gap, "grad_gap_leaf": grad_leaf,
            "change_gap": change_gap, "change_gap_leaf": change_leaf,
            "change_gap.median_leaf": median_leaf,
            "leaves_compared": float(len(moved)),
            "leaves_left_out": float(len(ref_change) - len(moved))}
