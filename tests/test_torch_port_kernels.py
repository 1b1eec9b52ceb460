"""The port's kernels K1 (bank-MLP) and K2 (nearest-vertex search) against the JAX package's
Pallas kernels, K3 (the metrics' nearest points, which no Pallas kernel had) against the JAX
package's distance block and its operation counts, K4's dispatch (the trunk's BN sites: on the
CPU the plain chain, the same operations the trunk ran before K4), plus the port's import and
device rules.

On the CPU each port wrapper takes its kernel's plain version; here that plain version is
held against the Pallas kernel run in interpret mode, on the inputs of the JAX package's own
kernel tests.  The hand-written kernels themselves are tested on the card by
``tests/test_torch_port_cuda.py``.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import roofline, roofline_k3
from vpho_tpu.engine.metrics import _pairwise_min_dist as jax_pairwise_min_dist
from vpho_tpu.ops.pallas_bank import fused_bank_mlp
from vpho_tpu.ops.pallas_dist import min_dist_and_idx as jax_min_dist
from vpho_tpu_torch.models import backbone as BB
from vpho_tpu_torch.models import layers as L
from vpho_tpu_torch.ops import bank_mlp as K1
from vpho_tpu_torch.ops import bn_act as K4
from vpho_tpu_torch.ops import metric_nn as K3
from vpho_tpu_torch.ops import min_dist as K2
from test_torch_port_cuda import (_bank_case, _dist_case, _nn_case, _port_bank,
                                  assert_argmin_equivalent, bn_stats)

torch.set_num_threads(1)


BANK_SHAPES = [
    (3, 16, 4, 256, 3),    # 16-aligned S
    (2, 5, 4, 256, 3),     # S < 16
    (2, 20, 2, 384, 3),    # S not a multiple of 16, wider hidden
    (1, 100, 8, 256, 3),   # the blessed S
    (5, 12, 4, 256, 3),    # B not divisible by the JAX kernel's group of 2
]


@pytest.mark.parametrize("B,S,n,D,O", BANK_SHAPES)
def test_bank_mlp_plain_matches_pallas(B, S, n, D, O):
    args = _bank_case(B * 100 + S, B, S, n, D, O)
    ref = np.asarray(fused_bank_mlp(*map(jnp.asarray, args), S, use_pallas=True, interpret=True))
    before = K1.launches
    got = _port_bank(*args, S).numpy()
    assert K1.launches == before          # the CPU path never counts a launch
    assert got.shape == (B * S, n, O)
    np.testing.assert_allclose(got, ref, rtol=0.03, atol=0.03)


@pytest.mark.parametrize("B,S,n,D,O", BANK_SHAPES)
def test_bank_mlp_prepared_is_bit_identical(B, S, n, D, O):
    """The prepared operands (W1 K-major, W2 padded to 8 columns in core-matrix order) hold
    exactly the plain ones: the prepared plain path equals the unprepared one bit for bit."""
    p, w1p, add, w2, b2 = _bank_case(B * 100 + S, B, S, n, D, O)
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dtype=dt)
    w = K1.prepare(t(w1p, bf), t(w2, bf), t(b2))
    assert w.w1t.shape == (n, D, 256) and w.w2p.shape == (n, D // 8, 8, 8)
    w1_back, w2_back = K1.unprepare(w)
    assert torch.equal(w1_back, t(w1p, bf)) and torch.equal(w2_back, t(w2, bf))
    assert not w.w2p[:, :, O:].any()                  # the padding columns are zero
    before = K1.launches
    got = K1.bank_mlp_prepared(t(p, bf), w, t(add), S)
    assert K1.launches == before
    torch.testing.assert_close(got, _port_bank(p, w1p, add, w2, b2, S), rtol=0, atol=0)


@pytest.mark.parametrize("loader", ["load_mano_pkl", "synthetic_mano", "load_mano",
                                    "build_registry_from_models_dir", "synthetic_registry",
                                    "load_registry", "load_anchor_tables"])
def test_loaders_default_to_cuda(monkeypatch, loader):
    from vpho_tpu_torch.models import anchor, mano, ycb

    calls = {
        "load_mano_pkl": lambda: mano.load_mano_pkl("MANO_RIGHT.pkl"),
        "synthetic_mano": lambda: mano.synthetic_mano(),
        "load_mano": lambda: mano.load_mano(),
        "build_registry_from_models_dir": lambda: ycb.build_registry_from_models_dir("models"),
        "synthetic_registry": lambda: ycb.synthetic_registry(verts_per_obj=64),
        "load_registry": lambda: ycb.load_registry(),
        "load_anchor_tables": lambda: anchor.load_anchor_tables(mano.synthetic_mano(device="cpu")),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[loader]()


@pytest.mark.parametrize("B,N,P,V", [
    (2, 8, 32, 256),
    (1, 5, 32, 128),     # odd N
    (3, 6, 32, 384),
    (1, 101, 16, 128),   # the S + 1 candidate count
    (2, 31, 32, 200),    # stage 5's odd N at P = 32
])
def test_min_dist_plain_matches_pallas(B, N, P, V):
    fp, verts = _dist_case(B * 1000 + N, B, N, P, V)
    d_ref, i_ref = jax_min_dist(jnp.asarray(fp), jnp.asarray(verts), use_pallas=True)
    before = K2.launches
    d, i = K2.min_dist_and_idx(torch.from_numpy(fp), torch.from_numpy(verts))
    assert K2.launches == before
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-5)
    assert_argmin_equivalent(fp, verts, i.numpy(), np.asarray(i_ref))


# ADD-S's P = Q without a mask, the full mesh's with ragged padding, P != Q
@pytest.mark.parametrize("N,P,Q,masked", [(2, 96, 96, False), (3, 120, 120, True),
                                          (2, 33, 70, False)])
def test_metric_nn_on_the_cpu_is_the_plain_form(N, P, Q, masked):
    """K3's wrapper on CPU tensors returns the plain form's numbers (any chunk), launches
    nothing, and both directions hold to the JAX package's distance block, exact zeros
    included."""
    a, b, mask = _nn_case(N * 1000 + P, N, P, Q, masked)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tm = None if mask is None else torch.from_numpy(mask)
    before = K3.launches
    d_ab, d_ba = K3.nearest(ta, tb, tm)
    assert K3.launches == before
    for got, ref in zip((d_ab, d_ba), K3.nearest_plain(ta, tb, tm, chunk=1)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    jm = None if mask is None else jnp.asarray(mask)
    ref = jax.jit(jax_pairwise_min_dist)
    # the jitted reference fuses its own sums: within test_object_metrics's rtol
    np.testing.assert_allclose(d_ab.numpy(), np.asarray(ref(a, b, jm)), rtol=1e-5, atol=0)
    np.testing.assert_allclose(d_ba.numpy(), np.asarray(ref(b, a, jm)), rtol=1e-5, atol=0)


def test_metric_nn_operation_counts():
    """8 operations a pair, each call's pairs once: the eval batch's four calls (two testers,
    each 64 x 4000^2 full-mesh and 64 x 2048^2 sampled pairs) are the benchmark's bound."""
    assert K3.flops(64, 4000, 4000) == 8 * 64 * 4000 * 4000
    assert K3.flops(1, 33, 1000) == 8 * 33 * 1000
    batch = 2 * (K3.flops(64, 4000, 4000) + K3.flops(64, 2048, 2048))
    assert roofline_k3.k3_flops(64) == batch == 8 * 2 * 64 * (4000 ** 2 + 2048 ** 2)
    assert batch / 8 == pytest.approx(2.58e9, rel=2e-3)
    assert roofline_k3.k3_least_s(64) == batch / roofline.PEAK_FP32_FLOPS
    assert roofline_k3.k3_least_s(1) == 2 * (K3.flops(1, 4000, 4000) + K3.flops(1, 2048, 2048)) \
        / roofline.PEAK_FP32_FLOPS


def test_cuda_wrappers_refuse_bad_inputs():
    meta = torch.empty((2, 3, 32, 3), device="meta")
    with pytest.raises(ValueError):
        K2.min_dist_and_idx(meta.half(), torch.empty((2, 10, 3), device="meta"))
    with pytest.raises(ValueError):
        K1.bank_mlp(torch.empty((8, 256), device="meta"),            # f32 where bf16 is due
                    torch.empty((4, 256, 256), device="meta", dtype=torch.bfloat16),
                    torch.empty((2, 4, 256), device="meta"),
                    torch.empty((4, 256, 3), device="meta", dtype=torch.bfloat16),
                    torch.empty((4, 3), device="meta"), 4)
    a, mask = torch.empty((2, 50, 3), device="meta"), torch.empty((2, 50), device="meta")
    for args in ((a.half(), a, None),                                # f16 points
                 (a, torch.empty((3, 50, 3), device="meta"), None),  # N differs
                 (a, torch.empty((2, 60, 3), device="meta"), mask[:, :1].expand(2, 50)),
                 (a, a, torch.empty((2, 60), device="meta")),        # mask not (N, P)
                 (a, a, mask.half()),
                 (a, torch.empty((2, 3, 50), device="meta").transpose(1, 2), None)):
        with pytest.raises(ValueError):
            K3.nearest(*args)


# The trunk's BN sites as the port ran them before K4, written out: the norm in float32 returned
# in the input's dtype, then the call site's residual add and activation.
def _chain_bn(bn, x):
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
                        0.0, bn.eps).to(x.dtype)


def _chain_bottleneck(blk, x):
    lrelu = lambda t: F.leaky_relu(t, 0.01)
    out = lrelu(_chain_bn(blk.bn1, blk.conv1(x)))
    out = lrelu(_chain_bn(blk.bn2, blk.conv2(out)))
    out = _chain_bn(blk.bn3, blk.conv3(out))
    residual = x if blk.downsample is None else \
        _chain_bn(blk.downsample[1], blk.downsample[0](x))
    return lrelu(out + residual.to(out.dtype))


def _chain_fpn(m, x):
    if m.compute_dtype is not None:
        x = x.to(m.compute_dtype)
    c1 = F.max_pool2d(F.leaky_relu(_chain_bn(m.layer0_h[1], m.layer0_h[0](x)), 0.01), 3, 2, 1)
    layer = lambda seq, t: [t := _chain_bottleneck(b, t) for b in seq[0]][-1]
    c2 = layer(m.layer1_h, c1)
    c3_h, c3_o = layer(m.layer2_h, c2), layer(m.layer2_o, c2)
    c4_h, c4_o = layer(m.layer3_h, c3_h), layer(m.layer3_o, c3_o)
    c5_h, c5_o = layer(m.layer4_h, c4_h), layer(m.layer4_h, c4_o)
    return m._top_down("h", c2, c3_h, c4_h, c5_h), m._top_down("o", c2, c3_o, c4_o, c5_o)


def _chain_residual(blk, x):
    lrelu = lambda t: F.leaky_relu(t, 0.01)
    h = blk.conv1(lrelu(_chain_bn(blk.bn, x)))
    h = blk.conv2(lrelu(_chain_bn(blk.bn1, h)))
    h = blk.conv3(lrelu(_chain_bn(blk.bn2, h)))
    skip = x if blk.conv4 is None else blk.conv4(x)
    return h + skip.to(h.dtype)


def _chain_encoder(m, x):
    x, x_ls = m.project(x), []
    for i, blk in enumerate(m.reg):
        x = _chain_residual(blk, x)
        if (i + 1) % m.n_modules == 0:
            x = F.max_pool2d(x, 2, 2)
            x_ls.append(x)
    return x.reshape(x.shape[0], -1), x_ls


def _chain_heatmap(m, x):
    x = _chain_bn(m.conv_layers[2], m.conv_layers[1](m.conv_layers[0](x)))
    x = torch.relu(_chain_bn(m.deconv_layers[1], m.deconv_layers[0](x)))
    return m.final_layer(x.float())


@pytest.mark.parametrize("act,residual", [(None, False), ("leaky", False), ("relu", False),
                                          ("leaky", True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_plain_is_the_chain(dtype, act, residual):
    """``bn_act_plain``, and ``bn_act`` on the CPU, equal the chain the BN sites ran before K4 bit
    for bit: the norm (``_chain_bn``), the add in x's dtype, leaky ReLU (0.01) or ReLU; K4 is
    not launched."""
    g = torch.Generator().manual_seed(3)
    bn = bn_stats(L.BatchNorm2d(24), "random", 1)
    x, r = ((torch.randn(3, 24, 5, 7, generator=g) * 2).to(dtype) for _ in range(2))
    res = r if residual else None
    want = _chain_bn(bn, x)
    want = want + r.to(want.dtype) if residual else want
    want = {None: want, "leaky": F.leaky_relu(want, 0.01), "relu": torch.nn.ReLU()(want)}[act]
    before = K4.launches
    for got in (L.bn_act_plain(bn, x, act, res), L.bn_act(bn, x, act, res)):
        assert got.dtype == dtype and torch.equal(got, want)
    with torch.inference_mode():
        assert torch.equal(L.bn_act(bn, x, act, res), want)
    assert K4.launches == before


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("module", ["fpn", "encoder", "heatmap"])
def test_trunk_modules_keep_the_chain(module, dtype):
    """On the CPU in eval mode the backbone, an encoder and a heatmap head, their BN sites routed
    through ``bn_act``, return what the chain written out above returns, bit for bit (BN
    statistics by the benchmark's rules, small inputs)."""
    g = torch.Generator().manual_seed(5)
    m, chain, shape = {
        "fpn": (lambda: BB.FPNBackbone(dtype), _chain_fpn, (2, 3, 32, 32)),
        "encoder": (lambda: L.Encoder(40, 32, compute_dtype=dtype), _chain_encoder,
                    (2, 40, 16, 16)),
        "heatmap": (lambda: L.HeadHeatmap(32, 5, 32, compute_dtype=dtype), _chain_heatmap,
                    (2, 32, 8, 8)),
    }[module]
    torch.manual_seed(0)
    m = m().eval()
    for i, bn in enumerate(b for b in m.modules() if isinstance(b, L.BatchNorm2d)):
        bn_stats(bn, "seed", i)
    x = torch.randn(shape, generator=g)
    with torch.inference_mode():
        got, want = m(x), chain(m, x)
    flat = lambda t: [t] if isinstance(t, torch.Tensor) else [u for v in t for u in flat(v)]
    assert len(flat(got)) == len(flat(want)) > 0
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_mode_bn_keeps_its_statistics(dtype):
    """In train mode (and under autograd) a BN site takes the plain chain: normalised with the
    batch's biased variance, the running statistics moved to 0.9 old + 0.1 batch, the
    gradient flowing; K4 is not launched."""
    g = torch.Generator().manual_seed(4)
    bn = bn_stats(L.BatchNorm2d(16), "seed", 2).train()
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    x = (torch.randn(4, 16, 6, 6, generator=g) * 2 + 1).to(dtype).requires_grad_()
    r = torch.randn(4, 16, 6, 6, generator=g).to(dtype)
    before = K4.launches
    y = L.bn_act(bn, x, "leaky", r)
    x32 = x.detach().float()
    var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
    want = F.batch_norm(x32, None, None, bn.weight.detach(), bn.bias.detach(), True, 0.0,
                        bn.eps).to(dtype)
    assert torch.equal(y.detach(), F.leaky_relu(want + r, 0.01))
    assert torch.equal(bn.running_mean, mean0.mul_(0.9).add_(mean, alpha=0.1))
    assert torch.equal(bn.running_var, var0.mul_(0.9).add_(var, alpha=0.1))
    y.float().sum().backward()
    assert x.grad is not None and bn.weight.grad is not None
    bn.eval()
    z = L.bn_act(bn, x, "relu")                     # eval mode, autograd recording
    assert z.requires_grad and torch.equal(z.detach(), torch.relu(_chain_bn(bn, x.detach())))
    assert K4.launches == before


def test_vpho_state_dict_keys_load_strictly():
    """Routing the BN sites through ``bn_act`` renamed nothing: ``VPHONet``'s 982 keys are the
    reference model's (``benchmark/weights.py::layout``) and load into it strictly."""
    from benchmark.weights import layout
    from vpho_tpu_torch.models.vpho import VPHONet

    with torch.device("meta"):
        port = VPHONet(compute_dtype=torch.bfloat16)
    sd = port.state_dict()
    assert len(sd) == 982
    assert [(k, tuple(v.shape), v.dtype) for k, v in sd.items()] == layout()
    with torch.device("meta"):
        VPHONet().load_state_dict(sd, strict=True)


def test_port_imports_no_jax():
    """Every module of the package, found by walking it, imports without pulling in jax, flax
    or the JAX package; neither the package's sources nor chip_smoke.py name them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vpho_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vpho_tpu_torch.__path__, 'vpho_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'vpho_tpu_torch.cli', 'vpho_tpu_torch.configs.config',\n"
        "        'vpho_tpu_torch.engine.trainer', 'vpho_tpu_torch.engine.runner',\n"
        "        'vpho_tpu_torch.engine.force_optim', 'vpho_tpu_torch.parallel.mesh',\n"
        "        'vpho_tpu_torch.engine.graphs'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'orbax', 'vpho_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    for path in [root / "chip_smoke.py", *sorted((root / "vpho_tpu_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(m.split(".")[0] in ("jax", "flax", "optax", "orbax", "vpho_tpu")
                               for m in mods), \
                    (path, mods)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.engine.runner import run
    from vpho_tpu_torch.engine.trainer import Trainer
    from vpho_tpu_torch.models import vpho as V

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = V.ModelConfig(sample_num=2, sampling_steps=2, topk_hand=1, topk_obj=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.make_context(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.build_model(cfg)
    full = get_config(["--mode", "eval", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(full)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(full)
    assert not any(tmp_path.iterdir())           # refused before writing anything
