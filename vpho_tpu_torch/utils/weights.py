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

``jax_variables_from_state_dict(sd)`` is the inverse, from the same ``_walk`` table: the Flax
trees as nested dicts of numpy arrays (``num_batches_tracked``, which Flax has no slot for, is
dropped).  ``save_final_model`` pickles them as the JAX package's ``final_model.pkl``.

The weights the JAX package reads from outside (``vpho_tpu/utils/torch_import.py``):
  * ``load_pretrain(model, path, remove_keys)`` is ``--pretrain``: a reference ``.pth`` (its
    keys are the port's, less the asset constants), or the JAX package's ``final_model.pkl``
    merged leaf by leaf (no jax needed to read it);
  * ``load_resnet50_into_backbone`` is ``--imagenet_pretrain``, a torchvision ResNet-50;
  * ``export_pkl_to_torch`` writes a ``final_model.pkl`` as a reference ``.pth``:

    python -m vpho_tpu_torch.utils.weights export <final_model.pkl> <out.pth>
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


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats", "buffers"}`` numpy trees -> torch ``state_dict``."""
    conv = _Converter(variables)
    _walk(lambda kind, tkey, *fpath: getattr(conv, kind)(tkey, *fpath))
    return {k: torch.from_numpy(np.array(v)) for k, v in conv.sd.items()}


class _Inverter:
    """The ``_Converter``'s layout conversions run backwards, into nested dicts."""

    def __init__(self, sd: Dict[str, np.ndarray], n_heads: int):
        self.sd = sd
        self.n_heads = n_heads
        self.tree = {"params": {}, "batch_stats": {}, "buffers": {}}

    def put(self, coll: str, path: Tuple[str, ...], value: np.ndarray):
        node = self.tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(value)

    def conv(self, tkey, *fpath):
        self.put("params", fpath + ("kernel",), np.transpose(self.sd[tkey + ".weight"], (2, 3, 1, 0)))
        if tkey + ".bias" in self.sd:
            self.put("params", fpath + ("bias",), self.sd[tkey + ".bias"])

    def deconv(self, tkey, *fpath):
        k = np.transpose(self.sd[tkey + ".weight"], (2, 3, 0, 1))[::-1, ::-1]
        self.put("params", fpath + ("kernel",), k)

    def linear(self, tkey, *fpath):
        self.put("params", fpath + ("kernel",), self.sd[tkey + ".weight"].T)
        self.put("params", fpath + ("bias",), self.sd[tkey + ".bias"])

    def bn(self, tkey, *fpath):
        base = fpath + ("BatchNorm_0",)
        self.put("params", base + ("scale",), self.sd[tkey + ".weight"])
        self.put("params", base + ("bias",), self.sd[tkey + ".bias"])
        self.put("batch_stats", base + ("mean",), self.sd[tkey + ".running_mean"])
        self.put("batch_stats", base + ("var",), self.sd[tkey + ".running_var"])

    def residual(self, tkey, *fpath):
        self.bn(tkey + ".bn", *fpath, "TorchBatchNorm_0")
        self.conv(tkey + ".conv1", *fpath, "Conv_0")
        self.bn(tkey + ".bn1", *fpath, "TorchBatchNorm_1")
        self.conv(tkey + ".conv2", *fpath, "Conv_1")
        self.bn(tkey + ".bn2", *fpath, "TorchBatchNorm_2")
        self.conv(tkey + ".conv3", *fpath, "Conv_2")
        if tkey + ".conv4.weight" in self.sd:
            self.conv(tkey + ".conv4", *fpath, "Conv_3")

    def bottleneck(self, tkey, *fpath):
        for i, name in enumerate(["conv1", "conv2", "conv3"]):
            self.conv(f"{tkey}.{name}", *fpath, f"Conv_{i}")
            self.bn(f"{tkey}.bn{i + 1}", *fpath, f"TorchBatchNorm_{i}")
        if tkey + ".downsample.0.weight" in self.sd:
            self.conv(tkey + ".downsample.0", *fpath, "Conv_3")
            self.bn(tkey + ".downsample.1", *fpath, "TorchBatchNorm_3")

    def mha(self, tkey, *fpath):
        w, b = self.sd[tkey + ".in_proj_weight"], self.sd[tkey + ".in_proj_bias"]
        d = w.shape[1]
        for i, name in enumerate(("query", "key", "value")):
            self.put("params", fpath + (name, "kernel"),
                     w[i * d:(i + 1) * d].T.reshape(d, self.n_heads, -1))
            self.put("params", fpath + (name, "bias"),
                     b[i * d:(i + 1) * d].reshape(self.n_heads, -1))
        self.put("params", fpath + ("out", "kernel"),
                 self.sd[tkey + ".out_proj.weight"].T.reshape(self.n_heads, -1, d))
        self.put("params", fpath + ("out", "bias"), self.sd[tkey + ".out_proj.bias"])

    def layernorm(self, tkey, *fpath):
        self.put("params", fpath + ("scale",), self.sd[tkey + ".weight"])
        self.put("params", fpath + ("bias",), self.sd[tkey + ".bias"])

    def fourier(self, tkey, *fpath):
        self.put("buffers", fpath, self.sd[tkey])

    def bank(self, tkey, *fpath):
        *scope, kname, bname = fpath
        self.put("params", tuple(scope) + (kname,), self.sd[tkey + ".weight"])
        self.put("params", tuple(scope) + (bname,), self.sd[tkey + ".bias"])


def jax_variables_from_state_dict(state_dict, n_heads: int = 2) -> Dict[str, dict]:
    """The port's ``state_dict`` -> Flax ``{"params", "batch_stats", "buffers"}`` numpy trees,
    the inverse of ``state_dict_from_jax`` (``n_heads``: the cross modules' attention heads)."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    inv = _Inverter(sd, n_heads)
    _walk(lambda kind, tkey, *fpath: getattr(inv, kind)(tkey, *fpath))
    return inv.tree


def save_final_model(model: torch.nn.Module, path: str) -> None:
    """Pickle ``model``'s weights as the JAX package's ``final_model.pkl``: its Flax trees as
    numpy arrays, read by ``--pretrain`` in either package."""
    with open(path, "wb") as f:
        pickle.dump(jax_variables_from_state_dict(model.state_dict()), f)




def save_torch_file(state_dict, path: str) -> None:
    """``torch.save`` a state_dict of tensors or numpy arrays (the reference's ``.pth``)."""
    torch.save({k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state_dict.items()}, path)


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` state_dict, read on the CPU without unpickling code."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def export_pkl_to_torch(pkl_path: str, out_path: str) -> str:
    """The JAX package's ``final_model.pkl`` -> a reference ``.pth`` (982 keys)."""
    with open(pkl_path, "rb") as f:
        variables = pickle.load(f)
    missing = [c for c in ("params", "batch_stats", "buffers") if c not in variables]
    if missing:
        raise ValueError(f"export needs the Flax collections params/batch_stats/buffers; "
                         f"{pkl_path} lacks {missing} (a params-only pickle cannot be exported; "
                         f"use the final_model.pkl a run writes)")
    save_torch_file(state_dict_from_jax(variables), out_path)
    return out_path


# keys of reference checkpoints that the port rebuilds from assets, outside its state_dict
_CONSTANT_KEYS = ("cross_hand.pose_embedder.pe", "cross_obj.pose_embedder.pe",
                  "head_physics.anchor")
_CONSTANT_PREFIXES = ("head_obj.", "head_mano.mano_layer.")
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def load_vpho_state_dict(model: torch.nn.Module, state_dict,
                         remove_keys=()) -> Dict[str, list]:
    """A reference ``vpho_net`` state_dict into ``model``, as the JAX package imports it: keys
    under a ``remove_keys`` prefix are dropped first, then a ``module.`` prefix that every key
    shares, then the asset constants.  A module whose keys are absent keeps its values.
    Returns the imported and missing modules and the unconsumed keys."""
    sd = {k: v for k, v in state_dict.items() if not k.startswith(tuple(remove_keys))}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items()
          if k not in _CONSTANT_KEYS and not k.startswith(_CONSTANT_PREFIXES)}
    imported, missing = [], []

    def do(kind, tkey, *fpath):
        probes = (tkey, tkey + ".weight", tkey + ".conv1.weight", tkey + ".in_proj_weight")
        (imported if any(p in sd for p in probes) else missing).append(tkey)

    _walk(do)
    own = model.state_dict()
    prefixes = tuple(t + "." for t in imported)           # a module's keys, or the key itself
    take = {k: v for k, v in sd.items() if k in own and (k + ".").startswith(prefixes)}
    model.load_state_dict(take, strict=False)
    return {"imported": imported, "missing": missing,
            "unconsumed": sorted(set(sd) - set(take))}


def load_resnet50_into_backbone(model: torch.nn.Module, state_dict) -> None:
    """A torchvision ResNet-50 state_dict into both trunk streams: the stem, ``layer1`` and
    ``layer4`` into the shared ``_h`` modules, ``layer2`` and ``layer3`` into the ``_h`` and the
    ``_o`` streams alike.  ``num_batches_tracked`` and ``fc`` are not read."""
    fe = "feature_extractor"
    pairs = [("conv1.weight", f"{fe}.layer0_h.0.weight")]
    pairs += [(f"bn1.{p}", f"{fe}.layer0_h.1.{p}") for p in _BN_KEYS]
    streams = {"layer1": ("layer1_h",), "layer2": ("layer2_h", "layer2_o"),
               "layer3": ("layer3_h", "layer3_o"), "layer4": ("layer4_h",)}
    for layer, n_blocks in (("layer1", 3), ("layer2", 4), ("layer3", 6), ("layer4", 3)):
        for b in range(n_blocks):
            names = [f"conv{i}.weight" for i in (1, 2, 3)]
            names += [f"bn{i}.{p}" for i in (1, 2, 3) for p in _BN_KEYS]
            if b == 0:
                names += ["downsample.0.weight"] + [f"downsample.1.{p}" for p in _BN_KEYS]
            for stream in streams[layer]:
                pairs += [(f"{layer}.{b}.{n}", f"{fe}.{stream}.0.{b}.{n}") for n in names]
    own = model.state_dict()
    with torch.no_grad():
        for src, dst in pairs:
            v = torch.as_tensor(state_dict[src])
            if v.shape != own[dst].shape:
                raise ValueError(f"resnet50 {src}: shape {tuple(v.shape)}, "
                                 f"{dst} has {tuple(own[dst].shape)}")
            own[dst].copy_(v)


def _drop_prefixes(tree, remove_keys, path=()):
    """Drop the subtrees whose '/'- or '.'-joined path starts with any prefix."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if any("/".join(p).startswith(r) or ".".join(p).startswith(r) for r in remove_keys):
            continue
        out[k] = _drop_prefixes(v, remove_keys, p) if isinstance(v, dict) else v
    return out


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _merge_final_model(model: torch.nn.Module, saved, remove_keys) -> Dict[str, list]:
    """The JAX package's non-strict merge of a ``final_model.pkl``: each Flax leaf the pickle
    has (``remove_keys`` subtrees dropped) replaces the model's, the others stay, a
    collection the pickle lacks is skipped.  A torch key is imported when any of its leaves
    came from the pickle (and a BN's ``num_batches_tracked`` with its running mean)."""
    state = model.state_dict()
    n_heads = model.cross_hand.attn.layers[0].self_attn.n_heads
    merged = jax_variables_from_state_dict(state, n_heads)
    given = jax_variables_from_state_dict(
        {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in state.items()}, n_heads)
    unconsumed = []
    for coll in ("params", "batch_stats", "buffers"):
        if coll not in saved:
            continue
        dst = dict(_leaves(merged[coll]))
        for path, v in _leaves(_drop_prefixes(saved[coll], tuple(remove_keys))):
            name = coll + "/" + "/".join(path)
            if path not in dst:
                unconsumed.append(name)
                continue
            if np.shape(v) != dst[path].shape:
                raise ValueError(f"--pretrain {name}: shape {np.shape(v)}, the model's "
                                 f"{dst[path].shape}")
            _node(merged[coll], path[:-1])[path[-1]] = np.asarray(v)
            _node(given[coll], path[:-1])[path[-1]] = np.ones(np.shape(v), bool)
    sd, flags = state_dict_from_jax(merged), state_dict_from_jax(given)
    counter = "num_batches_tracked"
    imported = {k for k in sd if bool(flags[k].any()) or (
        k.endswith(counter) and bool(flags[k[:-len(counter)] + "running_mean"].any()))}
    model.load_state_dict({k: sd[k] for k in imported}, strict=False)
    return {"imported": [k for k in sd if k in imported],
            "missing": [k for k in sd if k not in imported],
            "unconsumed": unconsumed}


def load_pretrain(model: torch.nn.Module, path: str, remove_keys=()) -> Dict[str, list]:
    """``--pretrain``: a reference ``.pth`` / ``.pt`` (``load_vpho_state_dict``) or the JAX
    package's ``final_model.pkl`` (``_merge_final_model``; no jax needed to read it), each with
    ``--remove_pretrained_keys``.  Returns the imported, missing and unconsumed names."""
    if path.endswith((".pth", ".pt")):
        return load_vpho_state_dict(model, load_torch_file(path), remove_keys)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    return _merge_final_model(model, saved, remove_keys)


if __name__ == "__main__":
    import sys

    if len(sys.argv) == 4 and sys.argv[1] == "export":
        print(export_pkl_to_torch(sys.argv[2], sys.argv[3]))
    else:
        print("usage: python -m vpho_tpu_torch.utils.weights export <final_model.pkl> <out.pth>",
              file=sys.stderr)
        sys.exit(1)
