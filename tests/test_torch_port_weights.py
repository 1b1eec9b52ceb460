"""The weights the port reads from outside (``vpho_tpu_torch/utils/weights.py``) against the JAX
package's ``vpho_tpu/utils/torch_import.py``, and the force-label entry points' device rule.

The Flax trees are the full model's (982 torch keys), in the shapes of
``jax_variables_from_state_dict(VPHONet().state_dict())``, filled from a numpy seed.  Every
comparison of weights is bitwise, key for key:
  * ``--pretrain x.pth``: a file written by JAX's ``export_vpho_state_dict`` +
    ``save_torch_file`` (plain, ``module.``-wrapped, with the asset constants and an unknown
    key, with ``--remove_pretrained_keys``, and both) loads into the port as JAX's
    ``load_pretrain`` into the same starting weights, carried over by ``state_dict_from_jax``;
    the reports' imported, missing and unconsumed lists are JAX's;
  * ``--imagenet_pretrain``: a state_dict in torchvision's ResNet-50 key format lands in the
    trunk as JAX's ``load_resnet50_into_backbone`` puts it, every other key unchanged;
  * export: ``python -m vpho_tpu_torch.utils.weights export`` writes JAX's
    ``export_pkl_to_torch`` file;
  * ``--pretrain final_model.pkl`` merges leaf by leaf, as JAX's: a pickle without
    ``buffers`` and one without a module's subtree load to JAX's tensors;
  * ``Trainer.init_state`` applies the ResNet-50 file, then ``--pretrain``.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from vpho_tpu.utils import torch_import as TI
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.utils import weights as W

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fill(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
        else:
            out[k] = rng.standard_normal(v.shape, dtype=np.float32)
            if k == "var":
                out[k] = np.abs(out[k]) + 0.5
    return out


@pytest.fixture(scope="module")
def trees():
    """(the file's weights, the model's starting weights) as Flax trees of numpy arrays."""
    shapes = W.jax_variables_from_state_dict(TV.VPHONet().state_dict())
    return _fill(shapes, np.random.default_rng(0)), _fill(shapes, np.random.default_rng(1))


def _model(variables):
    model = TV.VPHONet()
    model.load_state_dict(W.state_dict_from_jax(variables), strict=True)
    return model


def assert_bitwise(model, variables):
    got, ref = model.state_dict(), W.state_dict_from_jax(variables)
    assert sorted(got) == sorted(ref) and len(got) == 982
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].numpy().tobytes() == v.numpy().tobytes(), k


@pytest.mark.parametrize("variant", ["plain", "module", "constants", "remove", "module_remove"])
def test_reference_pth_loads_as_in_jax(trees, tmp_path, variant):
    file_vars, start = trees
    sd = TI.export_vpho_state_dict(file_vars)
    remove = ()
    if variant.startswith("module"):
        sd = {"module." + k: v for k, v in sd.items()}
    if variant.endswith("remove"):
        # a prefix without "module." matches nothing in a wrapped file, as in JAX
        remove = ("denoiser_hand", "head_mano.fc_pose", "module.encoder_obj.reg.3")
    if variant == "constants":
        rng = np.random.RandomState(2)
        sd.update({k: rng.randn(4, 3).astype(np.float32) for k in (
            "head_obj.verts_full", "head_mano.mano_layer.th_v_template",
            "cross_hand.pose_embedder.pe", "head_physics.anchor", "unknown.extra")})
    path = str(tmp_path / "ref.pth")
    TI.save_torch_file(sd, path)
    ref_vars, ref_rep = TI.load_pretrain(start, path, remove)
    model = _model(start)
    rep = W.load_pretrain(model, path, remove)
    assert_bitwise(model, ref_vars)
    assert rep == ref_rep
    if variant == "constants":
        assert rep["unconsumed"] == ["unknown.extra"]
    if variant == "remove":
        assert len(rep["missing"]) == 7 and "denoiser_hand.head.head.0" in rep["missing"]
    if variant == "module_remove":
        assert rep["missing"] == ["encoder_obj.reg.3"]


def _torchvision_resnet50(model, seed=3):
    """A state_dict under torchvision's resnet50 key names, in the shapes of the trunk."""
    own, rng = model.state_dict(), np.random.RandomState(seed)
    fe = "feature_extractor"
    shapes = {"conv1.weight": own[f"{fe}.layer0_h.0.weight"].shape,
              "fc.weight": (1000, 2048), "fc.bias": (1000,)}
    shapes.update({f"bn1.{p}": own[f"{fe}.layer0_h.1.{p}"].shape
                   for p in ("weight", "bias", "running_mean", "running_var")})
    for layer, stream in (("layer1", "layer1_h"), ("layer2", "layer2_h"), ("layer3", "layer3_h"),
                          ("layer4", "layer4_h")):
        head = f"{fe}.{stream}.0."
        shapes.update({layer + k[len(head) - 1:]: v.shape for k, v in own.items()
                       if k.startswith(head)})
    return {k: torch.tensor(7) if k.endswith("num_batches_tracked")
            else torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}


def test_resnet50_lands_where_jax_puts_it(trees):
    _, start = trees
    model = _model(start)
    sd = _torchvision_resnet50(model)
    assert "layer3.5.bn3.running_var" in sd and "layer2.0.downsample.1.weight" in sd
    W.load_resnet50_into_backbone(model, sd)
    ref = TI.load_resnet50_into_backbone(start, {k: v.numpy() for k, v in sd.items()})
    assert_bitwise(model, ref)
    changed = [k for k, v in W.state_dict_from_jax(start).items()
               if not torch.equal(v, model.state_dict()[k])]
    assert changed and all(k.startswith("feature_extractor.layer") for k in changed)
    assert not any(k.endswith("num_batches_tracked") for k in changed)


def _pickle(tree, path):
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return str(path)


def test_export_converter_writes_jax_file(trees, tmp_path):
    pkl = _pickle(trees[0], tmp_path / "final_model.pkl")
    TI.export_pkl_to_torch(pkl, str(tmp_path / "jax.pth"))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "vpho_tpu_torch.utils.weights", "export", pkl,
                          str(tmp_path / "port.pth")], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    got, ref = (torch.load(str(tmp_path / f), weights_only=True) for f in ("port.pth", "jax.pth"))
    assert list(got) == list(ref) and len(got) == 982
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].numpy().tobytes() == v.numpy().tobytes(), k
    with pytest.raises(ValueError, match="buffers"):
        W.export_pkl_to_torch(_pickle({"params": trees[0]["params"]}, tmp_path / "p.pkl"),
                              str(tmp_path / "x.pth"))


@pytest.mark.parametrize("cut", ["no_buffers", "no_module"])
def test_partial_final_model_merges_as_in_jax(trees, tmp_path, cut):
    file_vars, start = trees
    saved = {c: dict(t) for c, t in file_vars.items()}
    if cut == "no_buffers":
        del saved["buffers"]
    else:                       # one residual block's params and BN statistics, and a dense
        for coll in ("params", "batch_stats"):
            saved[coll]["encoder_hand"] = {k: v for k, v in saved[coll]["encoder_hand"].items()
                                           if k != "Residual_2"}
        saved["params"]["head_mano"] = {k: v for k, v in saved["params"]["head_mano"].items()
                                        if k != "Dense_1"}
        saved["params"]["retired_head"] = {"kernel": np.ones((2, 2), np.float32)}
    path = _pickle(saved, tmp_path / "final_model.pkl")
    ref_vars, ref_rep = TI.load_pretrain(start, path)
    model = _model(start)
    rep = W.load_pretrain(model, path)
    assert_bitwise(model, ref_vars)
    assert rep["unconsumed"] == ref_rep["unconsumed"]
    if cut == "no_buffers":
        assert sorted(rep["missing"]) == ["denoiser_hand.t_encoder.0.W",
                                          "denoiser_obj.t_encoder.0.W"]
    else:
        assert rep["unconsumed"] == ["params/retired_head/kernel"]
        assert "head_mano.base_layer.2.bias" in rep["missing"]
        assert "encoder_hand.reg.2.bn1.running_mean" in rep["missing"]
    assert len(rep["imported"]) + len(rep["missing"]) == 982


def test_trainer_applies_resnet50_then_pretrain(trees, tmp_path):
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.engine.trainer import Trainer

    file_vars, _ = trees
    pth = str(tmp_path / "ref.pth")
    W.save_torch_file(W.state_dict_from_jax(file_vars), pth)
    resnet = str(tmp_path / "resnet50.pth")
    torch.save(_torchvision_resnet50(TV.VPHONet()), resnet)
    cfg = get_config(["--mode", "eval", "--output_dir", str(tmp_path / "out"), "--sample_num", "2",
                      "--topk_hand", "1", "--topk_obj", "1", "--imagenet_pretrain", resnet,
                      "--pretrain", pth, "--remove_pretrained_keys", "feature_extractor.layer4_h"])
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    got = trainer.model.state_dict()
    want = W.state_dict_from_jax(file_vars)
    trunk = TV.VPHONet()
    W.load_resnet50_into_backbone(trunk, torch.load(resnet, weights_only=True))
    for k, v in got.items():
        src = trunk.state_dict() if k.startswith("feature_extractor.layer4_h.") else want
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, src[k]), k
    log = open(os.path.join(trainer.save_dir, "info.log")).read()
    assert f"Initialized backbone from {resnet}" in log
    assert "0 unconsumed" in log and "missing" in log


def test_force_optim_entry_points_need_a_gpu(monkeypatch):
    """Without a GPU, ``force_optim_main`` and ``python -m vpho_tpu_torch.engine.force_optim``
    stop and name ``device='cpu'``, as the eval entry point does."""
    from vpho_tpu_torch.cli import force_optim_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        force_optim_main([])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "vpho_tpu_torch.engine.force_optim"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0 and "device='cpu'" in res.stderr
