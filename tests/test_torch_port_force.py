"""The port's offline force labels (``vpho_tpu_torch/engine/force_optim.py`` and
``cli.force_optim_main``) against the JAX package's, on the CPU.

Inputs: synthetic-MANO hands (``synthetic_mano``, the same tables in both packages), B = 3,
from a numpy seed; JAX runs ``optimize_forces`` jitted.  Bars:
  * ``_losses`` at a fixed (scale, weight): the four terms within rtol 1e-5; the gradients of
    the gravity loss and of force + moment + distribution within rtol 1e-4 / atol 1e-7;
  * ``optimize_forces`` at reduced iteration counts (10 + 40 and 25 + 35): force_local,
    force_point and force_global within rtol 1e-4 / atol 1e-5, the four final losses within
    rtol 1e-4;
  * edge cases: a sample with no contact gets forces of exactly 0 and no NaN; through
    ``run_batch``, a left hand (gravity and CoM flipped) and an ungrasped sample (zeroed);
  * ``save_force``: the JAX package's paths, for DexYCB and HO3D, under a directory of the
    dataset's name and under one that is not (there both write beside the frames and the
    DexYCB loader reads zeros, as in JAX);
  * ``force_optim_main`` on a mini DexYCB tree named ``DexYCB`` (8 frames, bs 4, 5 + 20
    iterations on both sides): the same label files, within the ``optimize_forces`` bars, read
    back by the port's ``get_force``; on a mini HO3D tree (port only), the paths JAX's
    ``save_force`` gives, the last ``len % bs`` frames unlabelled.
"""
import functools
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.data import dexycb as JD
from vpho_tpu.engine import force_optim as JF
from vpho_tpu.models import anchor as JA
from vpho_tpu.models.mano import hand_verts_meters, synthetic_mano as jax_synthetic_mano
from vpho_tpu_torch.configs.config import Config
from vpho_tpu_torch.data import dexycb as D
from vpho_tpu_torch.data import ho3d as H
from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb, build_mini_ho3d
from vpho_tpu_torch.engine import force_optim as TF
from vpho_tpu_torch.models import anchor as TA
from vpho_tpu_torch.models.mano import synthetic_mano

torch.set_num_threads(1)

B = 3
OUT_KEYS = ("force_local", "force_point", "force_global")


@pytest.fixture(scope="module")
def case():
    """(JAX tables, port tables, numpy inputs): vertices, contact (some anchors under the 0.1
    threshold), unit gravity and a CoM near the hand."""
    jt = JA.load_anchor_tables(jax_synthetic_mano())
    tt = TA.load_anchor_tables(synthetic_mano(device="cpu"), device="cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.RandomState(0)
    pose = (rng.randn(B, 48) * 0.2).astype(np.float32)
    vert = np.asarray(hand_verts_meters(jax_synthetic_mano(), jnp.asarray(pose),
                                        jnp.zeros((B, 10)))[0])
    g = rng.randn(B, 1, 3) + [0.0, 2.0, 0.0]
    inputs = {
        "force_contact": (np.abs(rng.randn(B, 32)) * 0.5).astype(np.float32),
        "vert3d": vert.astype(np.float32),
        "gravity": (g / np.linalg.norm(g, axis=-1, keepdims=True)).astype(np.float32),
        "com": (vert.mean(1, keepdims=True) + rng.randn(B, 1, 3) * 0.02).astype(np.float32),
    }
    return jt, tt, inputs


def _args(inputs, tables, to):
    return [to(inputs[k]) for k in ("force_contact", "vert3d", "gravity", "com")] + [tables]


def test_losses_and_gradients_match_jax(case):
    jt, tt, inputs = case
    rng = np.random.RandomState(1)
    scale = (0.05 + rng.randn(B, 32) * 0.02).astype(np.float32)
    weight = (rng.randn(B, 32, 8) * 0.5).astype(np.float32)
    mask = (inputs["force_contact"] > 0.1).astype(np.float32)
    jargs = _args(inputs, jt, jnp.asarray)
    targs = _args(inputs, tt, torch.from_numpy)

    def jax_terms(s, w):
        return JF._losses(s, w, jnp.asarray(mask), *jargs)[:4]

    ts = torch.tensor(scale, requires_grad=True)
    tw = torch.tensor(weight, requires_grad=True)
    got = TF._losses(ts, tw, torch.from_numpy(mask), *targs)
    ref = jax_terms(jnp.asarray(scale), jnp.asarray(weight))
    for name, g, r in zip(("force", "gravity", "moment", "dist"), got[:4], ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5, err_msg=name)
    for name, pick in (("gravity", lambda t: t[1]), ("balance", lambda t: t[0] + t[2] + t[3])):
        jg = jax.grad(lambda s, w: pick(jax_terms(s, w)), argnums=(0, 1))(
            jnp.asarray(scale), jnp.asarray(weight))
        tg = torch.autograd.grad(pick(TF._losses(ts, tw, torch.from_numpy(mask), *targs)),
                                 [ts, tw])
        for var, g, r in zip(("scale", "weight"), tg, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} d/d{var}")


def assert_forces_close(got, ref, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("iters,no_contact", [((10, 50), False), ((25, 60), True)])
def test_optimize_forces_matches_jax(case, iters, no_contact):
    jt, tt, inputs = case
    inputs = dict(inputs)
    if no_contact:
        inputs["force_contact"] = inputs["force_contact"].copy()
        inputs["force_contact"][0] = 0.0
    ref = JF.optimize_forces(*_args(inputs, jt, jnp.asarray), iters_phase1=iters[0],
                             iters_total=iters[1])
    got = TF.optimize_forces(*_args(inputs, tt, torch.from_numpy), iters_phase1=iters[0],
                             iters_total=iters[1])
    assert_forces_close({k: got[k].numpy() for k in OUT_KEYS}, ref)
    for k, v in got["losses"].items():
        assert np.isfinite(v.item())
        np.testing.assert_allclose(v.item(), float(ref["losses"][k]), rtol=1e-4, err_msg=k)
    for k in OUT_KEYS:
        assert torch.isfinite(got[k]).all(), k
    if no_contact:
        assert (got["force_local"][0] == 0).all() and (got["force_global"][0] == 0).all()


def test_run_batch_flips_left_hands_and_zeroes_ungrasped(case, monkeypatch):
    jt, tt, inputs = case
    batch = {"force_contact": inputs["force_contact"], "gt_hand_vert_flip": inputs["vert3d"],
             "gravity": inputs["gravity"], "obj_CoM": inputs["com"],
             "is_right": np.array([True, False, True]), "is_grasped": np.array([1.0, 1.0, 0.0])}
    orig = JF.optimize_forces
    monkeypatch.setattr(JF, "optimize_forces",
                        lambda *a, **k: orig(*a, iters_phase1=4, iters_total=15))
    monkeypatch.setattr(TF, "PHASE1_ITERS", 4)
    monkeypatch.setattr(TF, "TOTAL_ITERS", 15)
    jopt = JF.ForceOptimizer.__new__(JF.ForceOptimizer)
    jopt.tables = jt
    ref = jopt.run_batch(batch)
    got = TF.ForceOptimizer(tt).run_batch(batch)
    assert_forces_close(got, ref)
    for k in ref["losses"]:
        np.testing.assert_allclose(got["losses"][k], ref["losses"][k], rtol=1e-4, err_msg=k)
    assert (got["force_local"][2] == 0).all() and (got["force_global"][2] == 0).all()
    assert np.abs(got["force_local"][1]).max() > 0
    # the left hand is optimized under gravity and CoM mirrored in x
    flip = np.array([[[1.0, 1.0, 1.0]], [[-1.0, 1.0, 1.0]], [[1.0, 1.0, 1.0]]], np.float32)
    mirrored = TF.optimize_forces(*_args(dict(inputs, gravity=inputs["gravity"] * flip,
                                              com=inputs["com"] * flip), tt, torch.from_numpy),
                                  iters_phase1=4, iters_total=15)
    np.testing.assert_array_equal(got["force_local"][:2], mirrored["force_local"][:2].numpy())


@pytest.mark.parametrize("dataset", ["dexycb", "ho3d"])
@pytest.mark.parametrize("named", [True, False])
def test_save_force_paths_are_jax(tmp_path, dataset, named):
    top = {"dexycb": "DexYCB", "ho3d": "HO3D_v2"}[dataset] if named else "frames"
    frame = {"dexycb": "20200820-subject-01/20200820_135500/836212060125/color_000007.jpg",
             "ho3d": "train/ABF10/rgb/0007.png"}[dataset]
    labels = {"force_local": np.arange(96, dtype=np.float32).reshape(1, 32, 3),
              "force_global": -np.arange(96, dtype=np.float32).reshape(1, 32, 3)}
    written = {}
    for name, opt in (("jax", JF.ForceOptimizer), ("port", TF.ForceOptimizer)):
        root = tmp_path / name / top
        opt.save_force(labels, [str(root / frame)], dataset)
        written[name] = sorted(os.path.relpath(os.path.join(r, f), tmp_path / name)
                               for r, _, fs in os.walk(tmp_path / name) for f in fs)
    assert written["port"] == written["jax"] and len(written["port"]) == 1
    root = str(tmp_path / "port" / top)
    if dataset == "dexycb":
        ds = D.DexYCBForceDataset.__new__(D.DexYCBForceDataset)
        ds.data_dir, ds._warned = root, set()
        if named:
            np.testing.assert_array_equal(ds.get_force(frame), labels["force_local"][0])
        else:       # written beside the frame, where the loader does not look (ROADMAP §3)
            assert written["port"][0].startswith(f"{top}/20200820-subject-01/")
            with pytest.warns(UserWarning, match="pseudo-force cache missing"):
                np.testing.assert_array_equal(ds.get_force(frame), 0.0)
    else:
        ds = H.HO3DForceDataset.__new__(H.HO3DForceDataset)
        ds._warned = set()
        np.testing.assert_array_equal(ds.get_force(os.path.join(root, frame)),
                                      labels["force_local"][0])


def _labels(root):
    out = {}
    for r, _, fs in os.walk(os.path.join(root, "cache", "hand_force")):
        for f in fs:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = pickle.load(fh)
    return out


def test_force_optim_main_on_dexycb_matches_jax(tmp_path, monkeypatch):
    root = build_mini_dexycb(str(tmp_path / "port" / "DexYCB"), n=8, seed=5)
    jroot = str(tmp_path / "jax" / "DexYCB")
    shutil.copytree(root, jroot)
    orig = JF.optimize_forces
    monkeypatch.setattr(JF, "optimize_forces",
                        lambda *a, **k: orig(*a, iters_phase1=5, iters_total=20))
    monkeypatch.setattr(JD, "load_registry", functools.lru_cache(maxsize=2)(JD.load_registry))
    monkeypatch.setattr(TF, "PHASE1_ITERS", 5)
    monkeypatch.setattr(TF, "TOTAL_ITERS", 20)
    monkeypatch.setattr(sys, "argv", ["force_optim.py", "--data_dir", jroot, "--batch_size", "4"])
    from vpho_tpu.cli import force_optim_main as jax_main
    from vpho_tpu_torch.cli import force_optim_main

    jax_main()
    force_optim_main(["--data_dir", root, "--batch_size", "4"], device="cpu")
    got, ref = _labels(root), _labels(jroot)
    assert sorted(got) == sorted(ref) and len(got) == 8
    for k in got:
        assert_forces_close(got[k], ref[k], ("force_local", "force_global"))
    ds = D.DexYCBForceDataset(Config(data_dir=root), root, is_train=True)
    for i in range(len(ds)):
        label = got[os.path.join("cache", "hand_force", ds.get_path(i).replace(
            ".jpg", ".pkl").replace("color_", "hand_force_"))]
        np.testing.assert_array_equal(ds.get_force(ds.get_path(i)), label["force_local"])


def test_force_optim_main_on_ho3d(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "HO3D_v2")
    build_mini_ho3d(root, n_train=11, n_eval=2)
    monkeypatch.setattr(TF, "PHASE1_ITERS", 3)
    monkeypatch.setattr(TF, "TOTAL_ITERS", 8)
    from vpho_tpu_torch.cli import force_optim_main

    force_optim_main(["--dataset_name", "ho3d", "--data_dir", root, "--batch_size", "4"],
                     device="cpu")
    assert capsys.readouterr().out.count("losses=") == 2
    got = _labels(root)
    ds = H.HO3DForceDataset(Config(data_dir=root, dataset_name="ho3d"), root, split="train")
    paths = [ds.get_path(i) for i in range(8)]           # 11 frames at bs 4: 3 unlabelled
    for p in paths:                                      # the loader reads the labels back
        assert any(np.array_equal(ds.get_force(p), v["force_local"]) for v in got.values())
        assert np.abs(ds.get_force(p)).max() > 0
    shutil.rmtree(os.path.join(root, "cache", "hand_force"))
    zeros = {"force_local": np.zeros((8, 32, 3)), "force_global": np.zeros((8, 32, 3))}
    JF.ForceOptimizer.save_force(zeros, paths, "ho3d")
    assert sorted(got) == sorted(_labels(root)) and len(got) == 8
