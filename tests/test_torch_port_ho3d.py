"""The port's HO3D loader and ``infer_ho3d`` against the JAX package's, on a mini HO3D tree
(``build_mini_ho3d``: 11 train frames, 3 evaluation frames listed in reverse in
``evaluation.txt``, 640x480 PNGs).

  * the three splits: lengths, frame lists (the evaluation split in ``evaluation.txt`` order)
    and paths;
  * items key for key, on ``test_torch_port_data``'s bars: train (augmented, host and device
    mode), valid and the GT-less evaluation items;
  * ``dump_codalab``: the same zip member and payload;
  * ``infer_ho3d`` end to end with the same weights (``state_dict_from_jax``), the same
    batches and the JAX package's own ODE start states: the two zips list the frames in the
    same (``evaluation.txt``) order, their joints and vertices within 1e-3 m of JAX's (the
    predict-parity bar of ``test_torch_port_eval``), the pkl rows alike.  Both get the
    batches with boxes wider than the crop, so that every candidate lies inside its heatmap
    (see ``test_torch_port_eval``).  Test size: patch 64, eval bs 2 (the second batch padded),
    S 2, 2 dpm3m steps, topk 1/1.
"""
import functools
import json
import os
import pickle
import zipfile

import jax
import numpy as np
import optax
import pytest
import torch

from vpho_tpu.configs.config import Config as JConfig
from vpho_tpu.configs.config import get_config as jax_get_config
from vpho_tpu.data import ho3d as JH
from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import trainer as JTR
from vpho_tpu_torch.configs.config import Config, get_config
from vpho_tpu_torch.data import dexycb as D
from vpho_tpu_torch.data import ho3d as H
from vpho_tpu_torch.data.fixtures_disk import build_mini_ho3d
from vpho_tpu_torch.engine import trainer as TTR
from vpho_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_data import assert_same_item
from test_torch_port_model import _random_variables

torch.set_num_threads(1)

N_TRAIN, N_EVAL = 11, 3
ARGV = ["--dataset_name", "ho3d", "--eval_batch_size", "2", "--sample_num", "2",
        "--sampling_steps", "2", "--patch_size", "64", "--topk_hand", "1", "--topk_obj", "1",
        "--num_devices", "1", "--viz_freq", "-1"]
WIDE = np.array([-100.0, -100.0, 164.0, 164.0], np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The mini tree and its ground truth; the JAX loader's registry (the same synthetic
    constants every time) is built once for the module."""
    root = str(tmp_path_factory.mktemp("HO3D_v2"))
    gt = build_mini_ho3d(root, n_train=N_TRAIN, n_eval=N_EVAL)
    mp = pytest.MonkeyPatch()
    mp.setattr(JH, "load_registry", functools.lru_cache(maxsize=2)(JH.load_registry))
    yield root, gt
    mp.undo()


def _pair(root, split, **over):
    kw = dict(data_dir=root, dataset_name="ho3d", patch_size=64, **over)
    return (H.HO3DForceDataset(Config(**kw), root, split=split),
            JH.HO3DForceDataset(JConfig(**kw), root, split=split))


def test_splits_match_jax(tree):
    root, _ = tree
    for split, n in (("train", N_TRAIN), ("valid", 2), ("test", N_EVAL)):
        port, ref = _pair(root, split)
        assert len(port) == len(ref) == n and port.index_ls == ref.index_ls
        assert [port.get_path(i) for i in range(n)] == [ref.get_path(i) for i in range(n)]
    assert [os.path.basename(p) for p in port.index_ls] == ["0002", "0001", "0000"]


@pytest.mark.parametrize("split,device", [("train", False), ("train", True), ("valid", False),
                                          ("test", False), ("test", True)])
def test_items_match_jax(tree, split, device):
    root, gt = tree
    port, ref = _pair(root, split, device_preprocess=device)
    for i in (0, 1):
        got = port[i]
        assert_same_item(got, ref[i])
        assert ("rgb_full" in got) == (device and split != "test")
    if split == "valid":
        np.testing.assert_allclose(port[0]["gt_joint"], gt["train"][0]["jt_cv"], atol=1e-4)
    if split == "test":
        assert "gt_joint" not in got
        np.testing.assert_allclose(port[1]["root_joint"], gt["eval"][1]["root_cv"], atol=1e-5)


def test_dump_codalab_matches_jax(tmp_path):
    joints = np.arange(2 * 21 * 3, dtype=np.float64).reshape(2, 21, 3) * 0.1234567
    verts = np.ones((2, 778, 3)) * 0.7654321
    got = H.dump_codalab(joints, verts, str(tmp_path / "port" / "submit" / "hand_reg"))
    ref = JH.dump_codalab(joints, verts, str(tmp_path / "jax" / "submit" / "hand_reg"))
    assert got.endswith("hand_reg.zip") and not os.path.exists(got[:-4] + ".json")
    with zipfile.ZipFile(got) as zg, zipfile.ZipFile(ref) as zr:
        assert zg.namelist() == zr.namelist() == ["hand_reg.json"]
        assert zg.read("hand_reg.json") == zr.read("hand_reg.json")


def _zip_payload(path):
    with zipfile.ZipFile(path) as z:
        return [np.asarray(a) for a in json.loads(z.read(z.namelist()[0]))]


@pytest.fixture(scope="module")
def inferred(tree, tmp_path_factory):
    root, _ = tree
    out = str(tmp_path_factory.mktemp("infer"))
    argv = ARGV + ["--mode", "infer", "--data_dir", root]
    test_ds = H.HO3DForceDataset(Config(data_dir=root, dataset_name="ho3d", patch_size=64),
                                 root, split="test")
    batches = list(D.make_loader(test_ds, 2, drop_last=False))
    for b in batches:
        for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
            b[k] = np.tile(WIDE, (2, 1))

    jt = JTR.Trainer(jax_get_config(argv + ["--output_dir", os.path.join(out, "jax")]))
    rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    sample = jax_make_batch(jt.ctx, jax.random.PRNGKey(8), 2, 64)
    variables = _random_variables(dict(jax.eval_shape(lambda: jt.model.init(rngs, sample, False))))
    jt.state = JTR.TrainState.create(
        apply_fn=jt.model.apply, params=variables["params"], tx=optax.sgd(0.0),
        batch_stats=variables["batch_stats"], buffers=variables["buffers"])
    jt.eval_dataset = JH.HO3DForceDataset(JConfig(data_dir=root, dataset_name="ho3d",
                                                  patch_size=64), root, split="test")
    ref = jt.infer_ho3d([dict(b) for b in batches])

    tt = TTR.Trainer(get_config(argv + ["--output_dir", os.path.join(out, "torch")]), "cpu")
    tt.init_state()
    tt.model.load_state_dict(state_dict_from_jax(variables), strict=True)
    tt.eval_dataset = test_ds
    sde, S, T0 = jt.ctx.sde, jt.cfg.sample_num, jt.cfg.sample_T0
    x0_for = lambda i, n: np.array(sde.prior(
        jax.random.fold_in(jax.random.PRNGKey(128), i), (n * S, 105), T=T0))
    got = tt.infer_ho3d([dict(b) for b in batches], x0_for=x0_for)
    return ref, got, jt, tt


def test_infer_ho3d_matches_jax(inferred):
    ref, got, jt, tt = inferred
    assert set(got["zips"]) == set(ref["zips"]) == {"hand_reg", "hand_diff"}
    for name in ("hand_reg", "hand_diff"):
        assert os.path.relpath(got["zips"][name], tt.save_dir) == \
            os.path.relpath(ref["zips"][name], jt.save_dir) == f"submit/{name}.zip"
        (gj, gv), (rj, rv) = _zip_payload(got["zips"][name]), _zip_payload(ref["zips"][name])
        assert gj.shape == rj.shape == (N_EVAL, 21, 3) and gv.shape == rv.shape == (N_EVAL, 778, 3)
        np.testing.assert_allclose(gj, rj, rtol=0, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-3, err_msg=name)
        # dataset order: the zip's frame k is evaluation.txt's line k, wherever it was batched
        assert np.abs(gj[0] - gj[1]).max() > 1e-3
    rows_g, rows_r = got["collector_res"], ref["collector_res"]
    assert [list(r) for r in rows_g] == [list(r) for r in rows_r]
    for g, r in zip(rows_g, rows_r):
        np.testing.assert_array_equal(g["index"], r["index"])
        assert g["path"] == r["path"]
        np.testing.assert_allclose(g["pd_obj_rt"], r["pd_obj_rt"], rtol=0, atol=1e-3)
        assert g["pd_hand_vert"].dtype == r["pd_hand_vert"].dtype == np.float16
    name = "my-prediction_align-2023_CVPR_HFL-infer.pkl"
    with open(os.path.join(tt.save_dir, name), "rb") as f:
        assert len(pickle.load(f)) == 2
    assert set(got["report"]["object"]) == {"one_candidate", "mean_candidate_pose"}
