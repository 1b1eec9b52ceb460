"""Carry weights from the JAX package's Flax variables into the port's ``VPHONet``.

``state_dict_from_jax(variables)`` takes the Flax ``params``, ``batch_stats`` and ``buffers``
trees (nested dicts of numpy arrays) and returns a torch ``state_dict`` under the reference
key names, which ``VPHONet.load_state_dict(..., strict=True)`` takes whole.  The key mapping
is this module's own copy of the JAX package's ``_walk_vpho``; the layout conversions are:

  * conv kernel (kh, kw, I, O) -> (O, I, kh, kw)
  * conv-transpose kernel (kh, kw, I, O) -> (I, O, kh, kw), spatially flipped (Flax applies
    the kernel unflipped; torch's transpose conv is the adjoint of a forward conv)
  * dense kernel (I, O) -> (O, I)
  * multi-head attention q/k/v (d, heads, head_dim) -> packed ``in_proj_weight`` [q; k; v]
  * batch norm scale/bias + mean/var -> weight/bias/running_mean/running_var and a zero
    ``num_batches_tracked``
MANO, YCB and anchor tables are constants outside the ``state_dict``.

``load_pretrain(model, path, remove_keys)`` is ``--pretrain`` for the JAX package's
``final_model.pkl`` (those trees pickled as numpy arrays; no jax needed to read it).
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def _walk(do: Callable[..., None]) -> None:
    """Call ``do(kind, torch_key, *flax_path)`` once per mapped module."""
    fe = "feature_extractor"
    do("conv", f"{fe}.layer0_h.0", fe, "stem", "Conv_0")
    do("bn", f"{fe}.layer0_h.1", fe, "stem", "TorchBatchNorm_0")
    layer_map = {"layer1_h.0": ("layer1", 3), "layer2_h.0": ("layer2_h", 4),
                 "layer2_o.0": ("layer2_o", 4), "layer3_h.0": ("layer3_h", 6),
                 "layer3_o.0": ("layer3_o", 6), "layer4_h.0": ("layer4", 3)}
    for tname, (fname, nb) in layer_map.items():
        for b in range(nb):
            do("bottleneck", f"{fe}.{tname}.{b}", fe, fname, f"Bottleneck_{b}")
    for nm in ["toplayer_h", "toplayer_o", "latlayer1_h", "latlayer2_h", "latlayer3_h",
               "latlayer1_o", "latlayer2_o", "latlayer3_o", "smooth3_h", "smooth3_o"]:
        do("conv", f"{fe}.{nm}", fe, nm)

    for side in ["hand", "obj"]:
        t = f"head_hm_{side}"
        do("conv", f"{t}.conv_layers.0", t, "Conv_0")
        do("conv", f"{t}.conv_layers.1", t, "Conv_1")
        do("bn", f"{t}.conv_layers.2", t, "TorchBatchNorm_0")
        do("deconv", f"{t}.deconv_layers.0", t, "ConvTranspose_0")
        do("bn", f"{t}.deconv_layers.1", t, "TorchBatchNorm_1")
        do("conv", f"{t}.final_layer", t, "Conv_2")

    for side in ["hand", "obj"]:
        t = f"encoder_{side}"
        do("conv", f"{t}.project", t, "Conv_0")
        for i in range(8):
            do("residual", f"{t}.reg.{i}", t, f"Residual_{i}")

    do("linear", "head_mano.base_layer.0", "head_mano", "Dense_0")
    do("linear", "head_mano.base_layer.2", "head_mano", "Dense_1")
    do("linear", "head_mano.fc_pose", "head_mano", "Dense_2")
    do("linear", "head_mano.fc_shape", "head_mano", "Dense_3")

    for side in ["hand", "obj"]:
        t = f"cross_{side}"
        do("conv", f"{t}.proj_hand", t, "Conv_0")
        do("conv", f"{t}.proj_obj", t, "Conv_1")
        do("linear", f"{t}.gravity_proj", t, "Dense_0")
        tl = f"{t}.attn.layers.0"
        fl = (t, "TransformerEncoderLayer_0")
        do("mha", f"{tl}.self_attn", *fl, "MultiHeadDotProductAttention_0")
        do("linear", f"{tl}.linear1", *fl, "Dense_0")
        do("linear", f"{tl}.linear2", *fl, "Dense_1")
        do("layernorm", f"{tl}.norm1", *fl, "LayerNorm_0")
        do("layernorm", f"{tl}.norm2", *fl, "LayerNorm_1")

    for seq in ("fc_scale", "fc_weight", "fc_CoM"):
        do("linear", f"head_physics.{seq}.0", "head_physics", f"{seq}_0")
        do("linear", f"head_physics.{seq}.2", "head_physics", f"{seq}_1")

    for t in ("denoiser_hand", "denoiser_obj"):
        do("fourier", f"{t}.t_encoder.0.W", t, "fourier", "W")
        do("linear", f"{t}.t_encoder.1", t, "t_dense")
        do("linear", f"{t}.pose_encoder.0", t, "pose_dense1")
        do("linear", f"{t}.pose_encoder.2", t, "pose_dense2")
        do("bank", f"{t}.head.head.0", t, "bank", "kernel1", "bias1")
        do("bank", f"{t}.head.head.2", t, "bank", "kernel2", "bias2")


def _node(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


class _Converter:
    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.buffers = variables["buffers"]
        self.sd: Dict[str, np.ndarray] = {}

    def p(self, *path) -> np.ndarray:
        return np.asarray(_node(self.params, path))

    def conv(self, tkey, *fpath):
        self.sd[tkey + ".weight"] = np.transpose(self.p(*fpath, "kernel"), (3, 2, 0, 1))
        if "bias" in _node(self.params, fpath):
            self.sd[tkey + ".bias"] = self.p(*fpath, "bias")

    def deconv(self, tkey, *fpath):
        k = self.p(*fpath, "kernel")[::-1, ::-1]
        self.sd[tkey + ".weight"] = np.transpose(k, (2, 3, 0, 1))

    def linear(self, tkey, *fpath):
        self.sd[tkey + ".weight"] = self.p(*fpath, "kernel").T
        self.sd[tkey + ".bias"] = self.p(*fpath, "bias")

    def bn(self, tkey, *fpath):
        base = fpath + ("BatchNorm_0",)
        self.sd[tkey + ".weight"] = self.p(*base, "scale")
        self.sd[tkey + ".bias"] = self.p(*base, "bias")
        self.sd[tkey + ".running_mean"] = np.asarray(_node(self.stats, base + ("mean",)))
        self.sd[tkey + ".running_var"] = np.asarray(_node(self.stats, base + ("var",)))
        self.sd[tkey + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def residual(self, tkey, *fpath):
        self.bn(tkey + ".bn", *fpath, "TorchBatchNorm_0")
        self.conv(tkey + ".conv1", *fpath, "Conv_0")
        self.bn(tkey + ".bn1", *fpath, "TorchBatchNorm_1")
        self.conv(tkey + ".conv2", *fpath, "Conv_1")
        self.bn(tkey + ".bn2", *fpath, "TorchBatchNorm_2")
        self.conv(tkey + ".conv3", *fpath, "Conv_2")
        if "Conv_3" in _node(self.params, fpath):
            self.conv(tkey + ".conv4", *fpath, "Conv_3")

    def bottleneck(self, tkey, *fpath):
        for i, name in enumerate(["conv1", "conv2", "conv3"]):
            self.conv(f"{tkey}.{name}", *fpath, f"Conv_{i}")
            self.bn(f"{tkey}.bn{i + 1}", *fpath, f"TorchBatchNorm_{i}")
        if "Conv_3" in _node(self.params, fpath):
            self.conv(tkey + ".downsample.0", *fpath, "Conv_3")
            self.bn(tkey + ".downsample.1", *fpath, "TorchBatchNorm_3")

    def mha(self, tkey, *fpath):
        ws, bs = [], []
        for name in ("query", "key", "value"):
            k = self.p(*fpath, name, "kernel")                 # (d, heads, head_dim)
            ws.append(k.reshape(k.shape[0], -1).T)
            bs.append(self.p(*fpath, name, "bias").reshape(-1))
        self.sd[tkey + ".in_proj_weight"] = np.concatenate(ws, axis=0)
        self.sd[tkey + ".in_proj_bias"] = np.concatenate(bs, axis=0)
        wo = self.p(*fpath, "out", "kernel")                   # (heads, head_dim, d)
        self.sd[tkey + ".out_proj.weight"] = wo.reshape(-1, wo.shape[-1]).T
        self.sd[tkey + ".out_proj.bias"] = self.p(*fpath, "out", "bias")

    def layernorm(self, tkey, *fpath):
        self.sd[tkey + ".weight"] = self.p(*fpath, "scale")
        self.sd[tkey + ".bias"] = self.p(*fpath, "bias")

    def fourier(self, tkey, *fpath):
        self.sd[tkey] = np.asarray(_node(self.buffers, fpath))

    def bank(self, tkey, *fpath):
        *scope, kname, bname = fpath
        self.sd[tkey + ".weight"] = self.p(*scope, kname)
        self.sd[tkey + ".bias"] = self.p(*scope, bname)


def state_dict_from_jax(variables, skip_missing: bool = False) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats", "buffers"}`` numpy trees -> torch ``state_dict``.
    ``skip_missing`` leaves out the modules whose Flax subtree is absent."""
    conv = _Converter(variables)

    def do(kind, tkey, *fpath):
        try:
            getattr(conv, kind)(tkey, *fpath)
        except KeyError:
            if not skip_missing:
                raise

    _walk(do)
    return {k: torch.from_numpy(np.array(v)) for k, v in conv.sd.items()}


def _drop_prefixes(tree, remove_keys, path=()):
    """Drop the subtrees whose '/'- or '.'-joined path starts with any prefix."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if any("/".join(p).startswith(r) or ".".join(p).startswith(r) for r in remove_keys):
            continue
        out[k] = _drop_prefixes(v, remove_keys, p) if isinstance(v, dict) else v
    return out


def load_pretrain(model: torch.nn.Module, path: str, remove_keys=()) -> Dict[str, list]:
    """``--pretrain``: load the JAX package's ``final_model.pkl`` (its Flax variables as
    numpy trees) into ``model``.  ``remove_keys`` drops Flax subtrees by path prefix before
    the conversion; with none dropped the load is strict.  Returns the loaded, missing and
    unexpected torch keys."""
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            "--pretrain with a reference .pth checkpoint is not ported yet (ROADMAP section 1, "
            "CLI and tooling: torch-side .pth import); pass the JAX package's final_model.pkl")
    with open(path, "rb") as f:
        saved = pickle.load(f)
    variables = {coll: _drop_prefixes(saved[coll], tuple(remove_keys))
                 for coll in ("params", "batch_stats", "buffers")}
    sd = state_dict_from_jax(variables, skip_missing=bool(remove_keys))
    missing, unexpected = model.load_state_dict(sd, strict=not remove_keys)
    return {"loaded": sorted(sd), "missing": list(missing), "unexpected": list(unexpected)}
