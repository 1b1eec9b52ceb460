"""The hand-written CUDA kernels (K1 bank-MLP, K2 nearest-vertex search, K3 the metrics'
nearest points, K4 the trunk's batch norm with its add and activation) against their plain
PyTorch versions on the card, the object metrics on the
card against the CPU, one training step on the card, the device preprocess
(``--device_preprocess``) on the card against itself on the CPU, and the captured steps
(``engine/graphs.py``): a replay equal to the eager run bit for bit, the kernels' tallies
counting replayed launches, the predict graph's stage marks read on every replay, a capture
that would wait on the device refused; the train step's graphs against eager steps (also in an
nccl group of one rank), the metric and preprocess graphs against their eager runs.

There is no CPU mode for a CUDA kernel, so every test here needs an NVIDIA GPU and skips
without one.  This file imports neither jax nor ``vpho_tpu``, so on a machine with a card and
no JAX it runs alone, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from vpho_tpu_torch.ops import bank_mlp as K1
from vpho_tpu_torch.ops import bn_act as K4
from vpho_tpu_torch.ops import metric_nn as K3
from vpho_tpu_torch.ops import min_dist as K2

pytestmark = pytest.mark.cuda


def _bank_case(seed, B, S, n, D, O, C=256):
    rng = np.random.RandomState(seed)
    return (rng.randn(B * S, C).astype(np.float32),
            (rng.randn(n, C, D) * 0.05).astype(np.float32),
            rng.randn(B, n, D).astype(np.float32),
            (rng.randn(n, D, O) * 0.05).astype(np.float32),
            (rng.randn(n, O) * 0.1).astype(np.float32))


def _port_bank(p, w1p, add, w2, b2, S, device="cpu"):
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(device=device, dtype=dt)
    return K1.bank_mlp(t(p, bf), t(w1p, bf), t(add), t(w2, bf), t(b2), S)


def _dist_case(seed, B, N, P, V, fp_scale=1.0, v_scale=0.7):
    rng = np.random.RandomState(seed)
    return ((fp_scale * rng.randn(B, N, P, 3)).astype(np.float32),
            (v_scale * rng.randn(B, V, 3)).astype(np.float32))


def assert_argmin_equivalent(fp, verts, idx_got, idx_ref, rel=1e-6):
    """``idx`` must match where the best two squared distances are more than ``rel`` x the
    largest apart; elsewhere the chosen vertex may be any within that band of the best."""
    d2 = [((fp[b, :, :, None].astype(np.float64) - verts[b].astype(np.float64)) ** 2).sum(-1)
          for b in range(fp.shape[0])]                                  # (N, P, V) each
    scale = max(d.max() for d in d2)
    for b, d in enumerate(d2):
        two = np.partition(d, 1, axis=-1)[..., :2]
        clear = (two[..., 1] - two[..., 0]) > rel * scale
        np.testing.assert_array_equal(idx_got[b][clear], idx_ref[b][clear])
        pick = lambda i: np.take_along_axis(d, i[..., None].astype(np.int64), -1)[..., 0]
        assert np.all(pick(idx_got[b]) <= pick(idx_ref[b]) + rel * scale)


def rts(rng, n, rotation, spread=0.05, angle=1.0):
    """Camera-frame (n, 3, 4) ground-truth poses ~0.6 m out and predictions near them;
    ``rotation`` turns (n, 3) float32 axis-angles into (n, 3, 3) numpy matrices."""
    R = rotation(rng.randn(n, 3).astype(np.float32) * angle)
    t = np.concatenate([rng.randn(n, 2) * 0.02, 0.5 + rng.rand(n, 1) * 0.2], -1)
    gt = np.concatenate([R, t[..., None]], -1).astype(np.float32)
    dR = rotation(rng.randn(n, 3).astype(np.float32) * spread)
    pd = np.concatenate([np.einsum("nij,njk->nik", dR, R),
                         (t + rng.randn(n, 3) * spread * 0.1)[..., None]], -1)
    return pd.astype(np.float32), gt


def metric_inputs(rotation):
    """The metric tests' inputs: 6 samples' object poses (``rts``), ids and cameras, and hands
    ~0.6 m out with predictions ~1 cm off."""
    rng = np.random.RandomState(4)
    n = 6
    pd_rt, gt_rt = rts(rng, n, rotation)
    gt_joint = (rng.randn(n, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    gt_vert = (rng.randn(n, 778, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    return dict(
        pd_rt=pd_rt, gt_rt=gt_rt, obj_ids=rng.randint(0, 21, n).astype(np.int32),
        cam=np.tile(np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]], np.float32),
                    (n, 1, 1)) * np.array([1.0, 1.1, 0.9, 1.0, 1.2, 1.0])[:, None, None]
        .astype(np.float32),
        gt_joint=gt_joint, pd_joint=(gt_joint + rng.randn(n, 21, 3) * 0.01).astype(np.float32),
        gt_vert=gt_vert, pd_vert=(gt_vert + rng.randn(n, 778, 3) * 0.01).astype(np.float32),
        is_right=np.array([True, False, True, True, False, True]))


def _nn_case(seed, N, P, Q, masked=False):
    """K3's inputs: points ~0.6 m from the camera, as ``metric_inputs`` places them; b a few mm
    from a's first Q points, a fifth of them exact copies (zero distances).  ``masked``: each
    sample has a ragged number of real points (P == Q), the rest padding that repeats its
    first point, as the registry pads a mesh."""
    rng = np.random.RandomState(seed)
    a = rng.randn(N, max(P, Q), 3) * 0.05 + [0, 0, 0.6]
    b = a[:, :Q] + rng.randn(N, Q, 3) * 0.003 * (rng.rand(N, Q, 1) > 0.2)
    a, mask = a[:, :P], None
    if masked:
        real = P - rng.randint(0, P // 3, N)
        real[0] = P                                          # one sample without padding
        mask = (np.arange(P)[None] < real[:, None]).astype(np.float32)
        a = np.where(mask[..., None] > 0, a, a[:, :1])
        b = np.where(mask[..., None] > 0, b, b[:, :1])
    return a.astype(np.float32), b.astype(np.float32), mask


def bn_stats(bn, kind, seed):
    """Fill an eval-mode BN module's statistics and affine parameters: "seed" by the
    benchmark's rules (``benchmark/weights.py``: means N(0, 0.1), variances e^N(0, 0.3), scales
    N(1, 0.1), shifts N(0, 0.02)), "random" far wider (means N(0, 3), variances e^N(0, 3),
    scales N(0, 2), shifts N(0, 1))."""
    g = torch.Generator().manual_seed(seed)
    C = bn.num_features
    r = lambda s: torch.randn(C, generator=g) * s
    wide = kind == "random"
    with torch.no_grad():
        bn.running_mean.copy_(r(3.0 if wide else 0.1))
        bn.running_var.copy_(r(3.0 if wide else 0.3).exp())
        bn.weight.copy_(r(2.0) if wide else 1.0 + r(0.1))
        bn.bias.copy_(r(1.0 if wide else 0.02))
    return bn.eval()


def ulps(got, want):
    """(elements that differ, the largest difference in units in the last place of the dtype)
    of two tensors of one dtype, by their bits read as ordered integers."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    lo = torch.iinfo(bits).min

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, lo - i, i)

    d = (ordered(got) - ordered(want)).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# K1's shapes: the blessed one, then its edges.  R < 64 (1 x 37); tiles spanning up to 4
# samples, whose ``add`` rows are staged with the tile (16, 37, 150), and more, read from L2
# (5, 9); n = 1 and 5, not a multiple of the row ranges per bank; O = 1..4.
K1_SHAPES = [(64, 100, 32, 3), (1, 37, 32, 3), (3, 16, 32, 3), (2, 150, 32, 3),
             (20, 5, 5, 1), (7, 9, 1, 4), (4, 37, 5, 2), (3, 100, 1, 3)]


@pytest.mark.parametrize("B,S,n,O", K1_SHAPES)
def test_bank_mlp_kernel_matches_plain(cuda_device, B, S, n, O):
    D = 256
    p, w1p, add, w2, b2 = _bank_case(7, B, S, n, D, O)
    # atol 1e-3 / rtol 1e-2: kernel and plain sum in other orders, so a hidden value on a bf16
    # rounding boundary may round either way; that one-ulp flip times |W2| must stay under
    # 1e-3, hence the smaller W2
    w2 = w2 * 0.2
    before = K1.launches
    got = _port_bank(p, w1p, add, w2, b2, S, cuda_device)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(cuda_device, dt)
    ref = K1.bank_mlp_plain(t(p, bf), t(w1p, bf), t(add), t(w2, bf), t(b2), S)
    torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-3)


# stage 4 (N 100), stage 5 (N 31), the standalone object cascade's force selection at
# N = topk_obj^2 (100, 9, 1), and odd edges
@pytest.mark.parametrize("B,N,V", [(64, 100, 2048), (64, 31, 2048), (64, 9, 2048), (64, 1, 2048),
                                   (2, 1, 2048), (1, 7, 5000)])
def test_min_dist_kernel_matches_plain(cuda_device, B, N, V):
    # the main path's scale: force points within ~0.1 m of object vertices ~0.05 m out
    fp, verts = _dist_case(11, B, N, 32, V, fp_scale=0.08, v_scale=0.05)
    before = K2.launches
    d, i = K2.min_dist_and_idx(torch.from_numpy(fp).to(cuda_device),
                               torch.from_numpy(verts).to(cuda_device))
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    # the plain reference runs on the card too: on the host CPU its rounding of
    # |x|^2 + |y|^2 - 2xy differs, and near a zero distance the square root magnifies that
    # past the bar
    d_ref, i_ref = K2.min_dist_plain(torch.from_numpy(fp).to(cuda_device),
                                     torch.from_numpy(verts).to(cuda_device))
    np.testing.assert_allclose(d.cpu().numpy(), d_ref.cpu().numpy(), rtol=0, atol=1e-5)
    assert_argmin_equivalent(fp, verts, i.cpu().numpy(), i_ref.cpu().numpy())


# K3's shapes: ADD-S's 2048 x 2048 at N 1, 3 and 64; the full mesh's 4000 x 4000 with its
# padding masked; P != Q at ragged sizes
K3_SHAPES = [(1, 2048, 2048, False), (3, 2048, 2048, False), (64, 2048, 2048, False),
             (3, 4000, 4000, True), (1, 1, 1000, False), (2, 33, 1000, False),
             (3, 777, 1000, False)]


@pytest.mark.parametrize("N,P,Q,masked", K3_SHAPES)
def test_metric_nn_kernel_matches_plain_bit_for_bit(cuda_device, N, P, Q, masked):
    a, b, mask = (None if x is None else torch.from_numpy(x).to(cuda_device)
                  for x in _nn_case(N * 10000 + P, N, P, Q, masked))
    before = K3.launches
    got = K3.nearest(a, b, mask)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    ref = K3.nearest_plain(a, b, mask)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), r.view(torch.int32)), \
            int((g.view(torch.int32) != r.view(torch.int32)).sum())


def trunk_sites(model):
    """The trunk's BN sites, counted from the module tree: every ``BatchNorm2d`` once and the
    shared layer4's again, as the object stream runs it too (147 for ``VPHONet``: 95 in the
    backbone, 52 in the heatmap heads and encoders)."""
    from vpho_tpu_torch.models.layers import BatchNorm2d

    count = lambda m: sum(isinstance(x, BatchNorm2d) for x in m.modules())
    return count(model) + count(model.feature_extractor.layer4_h)


def _checked_sites(monkeypatch, model):
    """From here on every K4 launch is held against ``bn_act_plain`` on the same inputs; returns
    the list each launch appends to: (shape, dtype, layout, act, residual, elements that
    differ, largest ulp difference, same strides)."""
    from vpho_tpu_torch.models import layers as L

    by_mean = {m.running_mean.data_ptr(): m for m in model.modules()
               if isinstance(m, L.BatchNorm2d)}
    real, sites = K4.bn_act, []

    def checked(x, mean, var, weight, bias, eps, act=None, residual=None):
        got = real(x, mean, var, weight, bias, eps, act, residual)
        want = L.bn_act_plain(by_mean[mean.data_ptr()], x, act, residual)
        sites.append((tuple(x.shape), x.dtype, K4._layout(x), act, residual is not None)
                     + ulps(got, want) + (got.stride() == want.stride(),))
        return got

    monkeypatch.setattr(K4, "bn_act", checked)
    return sites


@pytest.mark.parametrize("stats", ["seed", "random"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bn_act_kernel_at_every_trunk_site(cuda_device, monkeypatch, dtype, stats):
    """The blessed trunk (patch 256, ``VPHONet.trunk`` in eval mode, no autograd) at B 64 and
    B 1: each of its 147 BN sites launches K4 once, equal bit for bit and stride for stride to
    ``bn_act_plain`` on the same input.  The weights are the benchmark's for seed 7, the BN
    statistics those or wide random ones (``bn_stats``)."""
    from benchmark.weights import make_state_dict
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.models import layers as L
    from vpho_tpu_torch.models import vpho as V

    cfg = V.ModelConfig(compute_dtype=dtype)
    ctx = V.make_context(cfg, device=cuda_device)
    model = V.build_model(cfg, device=cuda_device)
    model.load_state_dict(make_state_dict(7, cuda_device))
    if stats == "random":
        for i, m in enumerate(m for m in model.modules() if isinstance(m, L.BatchNorm2d)):
            bn_stats(m, "random", i)
    sites = _checked_sites(monkeypatch, model)
    for B in (64, 1):
        del sites[:]
        batch = fixtures.make_batch(ctx, seed=B, batch_size=B, patch_size=256)
        with torch.inference_mode():
            model.trunk(batch)
        torch.cuda.synchronize()
        assert len(sites) == trunk_sites(model) == 147
        assert {s[1] for s in sites} == {getattr(torch, dtype)}
        bad = [s for s in sites if s[5] or not s[7]]
        assert not bad, (B, bad)


# K4's edge shapes: vector paths (H x W a multiple of 8 in NCHW, C in channels-last), ragged
# H x W (5 x 7) and C (21, 3) that take the scalar path, a 1 x 1 map (both layouts at once)
BN_SHAPES = [(64, 256, 16, 16), (1, 2048, 8, 8), (3, 24, 5, 7), (2, 21, 6, 6), (2, 40, 1, 1),
             (1, 3, 9, 9)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_bn_act_kernel_matches_plain_at_edge_shapes(cuda_device, dtype, layout):
    """K4 against ``bn_act_plain`` bit for bit at ``BN_SHAPES``, both kinds of statistics,
    every activation, with and without a residual; then an input and a residual 2 or 4 bytes
    off 16-byte alignment (the scalar path)."""
    from vpho_tpu_torch.models.layers import BatchNorm2d, bn_act_plain

    g = torch.Generator().manual_seed(0)

    def check(bn, x, r):
        for act in K4.ACTS:
            for res in (None, r):
                got = K4.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                bn.eps, act, res)
                want = bn_act_plain(bn, x, act, res)
                assert got.stride() == want.stride() == x.stride()
                assert ulps(got, want) == (0, 0), (tuple(x.shape), act, res is not None)

    for i, shape in enumerate(BN_SHAPES):
        for kind in ("seed", "random"):
            bn = bn_stats(BatchNorm2d(shape[1]), kind, i).to(cuda_device)
            x, r = ((torch.randn(shape, generator=g) * 2).to(cuda_device, dtype)
                    .contiguous(memory_format=layout) for _ in range(2))
            check(bn, x, r)
    N, C, H, W = 2, 24, 5, 8
    bn = bn_stats(BatchNorm2d(C), "seed", 0).to(cuda_device)
    buf = (torch.randn(2, N * C * H * W + 1, generator=g) * 2).to(cuda_device, dtype)
    view = lambda t: t[1:].view(N, C, H, W) if layout == torch.contiguous_format else \
        t[1:].view(N, H, W, C).permute(0, 3, 1, 2)
    check(bn, view(buf[0]), view(buf[1]))


def test_bn_act_wrapper_refuses_bad_inputs(cuda_device):
    """A strided input, a dtype other than bf16 / f32, a tensor off the card, a residual that
    differs from x in layout, dtype or shape, statistics of another length or dtype, or an
    unknown activation raise before any launch."""
    from vpho_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(8).to(cuda_device).eval()
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    x = torch.randn(2, 8, 4, 4, device=cuda_device)
    before = K4.launches
    for bad in (x[..., ::2], x.transpose(2, 3), x.half(), x.double(), x.cpu(), x[0]):
        with pytest.raises(ValueError):
            K4.bn_act(bad, *stats)
    for res in (x.contiguous(memory_format=torch.channels_last), x.bfloat16(), x[:1]):
        with pytest.raises(ValueError):
            K4.bn_act(x, *stats, "leaky", res)
    for i, t in enumerate((bn.running_mean.half(), bn.running_var[:4])):
        with pytest.raises(ValueError):
            K4.bn_act(x, *(t if j == i else s for j, s in enumerate(stats)))
    with pytest.raises(ValueError):
        K4.bn_act(x, *stats, "gelu")
    assert K4.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_predict_equals_the_plain_chain(cuda_device, monkeypatch, dtype):
    """``forward_predict`` with K4 at the trunk's BN sites (statistics by ``bn_stats``' seed
    rules) equals it with every site forced onto ``bn_act_plain``, bit for bit; cuDNN's
    deterministic algorithms, as the f32 deconvolutions may sum with atomics."""
    from vpho_tpu_torch.models import backbone
    from vpho_tpu_torch.models import layers as L

    V, ctx, model, batch, x0s = _small_predict(cuda_device, dtype)
    for i, m in enumerate(m for m in model.modules() if isinstance(m, L.BatchNorm2d)):
        bn_stats(m, "seed", i)
    torch.backends.cudnn.deterministic = True
    try:
        before = K4.launches
        fused = V.forward_predict(model, ctx, batch, x0=x0s[0])
        assert K4.launches - before == trunk_sites(model)
        monkeypatch.setattr(L, "bn_act", L.bn_act_plain)
        monkeypatch.setattr(backbone, "bn_act", L.bn_act_plain)
        before = K4.launches
        plain = V.forward_predict(model, ctx, batch, x0=x0s[0])
        assert K4.launches == before
    finally:
        torch.backends.cudnn.deterministic = False
    assert set(fused) == set(plain)
    for k, v in plain.items():
        assert torch.equal(fused[k], v), k


def test_object_metrics_on_the_card_match_the_cpu(cuda_device):
    """``object_metrics`` with K3 on the card against the port on the CPU (the plain form), at
    the metric tests' inputs (rotations by the port's transform: this file has no JAX), with
    ``test_object_metrics``'s assertions, which hold the CPU's numbers to the JAX package's."""
    from vpho_tpu_torch.engine import metrics as M
    from vpho_tpu_torch.engine import tester as TE
    from vpho_tpu_torch.models import vpho as V
    from vpho_tpu_torch.utils import transforms as TR

    a = metric_inputs(lambda aa: TR.axis_angle_to_matrix(torch.from_numpy(aa)).numpy())
    args = [torch.from_numpy(a[k]) for k in ("pd_rt", "gt_rt", "obj_ids", "cam")]
    mcfg = V.ModelConfig(sample_num=2, topk_hand=1, topk_obj=1)
    ref = M.object_metrics(V.make_context(mcfg, device="cpu").registry, *args)
    before = K3.launches
    got = M.object_metrics(V.make_context(mcfg, device=cuda_device).registry,
                           *[t.to(cuda_device) for t in args])
    torch.cuda.synchronize()
    assert K3.launches == before + 2
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].cpu().numpy(), ref[k].numpy()
        if k in TE.RATE_KEYS or k.startswith("FSCORE@"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0, err_msg=k)


def test_train_step_on_the_card(cuda_device, tmp_path):
    """One training step on the card at test size (``forward_train``, the gradients, the
    optimizer, as ``Trainer.train_step`` runs them): every loss finite, the parameters with a
    zero gradient unmoved (a conv bias that feeds a train-mode BN can have an exactly zero
    one), every other moved unless its gradient is so small (< 1e-6) that Adam's step falls
    under the parameter's float32 spacing; the BN running statistics moved."""
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer
    from vpho_tpu_torch.models import vpho as V

    cfg = get_config(["--mode", "train", "--batch_size", "2", "--patch_size", "64",
                      "--repeat_num", "2", "--output_dir", str(tmp_path)])
    trainer = Trainer(cfg, cuda_device)
    trainer.init_state(8)
    model = trainer.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = fixtures.make_batch(trainer.ctx, seed=0, batch_size=2, patch_size=64)
    total, losses = V.forward_train(model, trainer.ctx, batch,
                                    generator=torch.Generator(cuda_device).manual_seed(0))
    assert len(losses) == 14 and all(bool(torch.isfinite(v)) for v in losses.values())
    params = trainer.optimizer.params
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(total, params, allow_unused=True))]
    assert trainer.optimizer.step(grads)
    for name, g in zip(trainer.optimizer.names, grads):
        unmoved = torch.equal(model.state_dict()[name], before[name])
        assert unmoved if not g.any() else (not unmoved or g.abs().max() < 1e-6), name
    assert sum(bool(g.any()) for g in grads) >= 0.8 * len(grads)
    stats = [k for k in before if k.endswith("running_var")]
    assert all(not torch.equal(model.state_dict()[k], before[k]) for k in stats)


@pytest.mark.parametrize("is_train", [False, True])
def test_device_preprocess_on_the_card_matches_the_cpu(cuda_device, tmp_path, is_train):
    """The device preprocess of a mini DexYCB batch (640x480 frames, one left hand, patch 128)
    on the card and on the CPU, float32, the same inputs and erase noise: rgb within 2e-4
    (normalized units; the blur and the jitter's mean sum in other orders), heatmaps within
    1e-5."""
    from vpho_tpu_torch.configs.config import Config
    from vpho_tpu_torch.data import dexycb as D
    from vpho_tpu_torch.data.device_pipeline import draw_erase_noise, preprocess_batch
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb

    root = build_mini_dexycb(str(tmp_path), n=4, seed=3, sides=["right", "left", "right", "right"])
    cfg = Config(data_dir=root, patch_size=128, device_preprocess=True)
    ds = D.DexYCBForceDataset(cfg, root, is_train=is_train)
    raw = {k: torch.as_tensor(v) for k, v in D.collate([ds[i] for i in range(4)]).items()}
    noise = draw_erase_noise(raw, 128, "pixel", torch.Generator().manual_seed(0)) \
        if is_train else None
    kw = dict(patch_size=128, heatmap_size=64, hand_sigma=2.0, obj_sigma=2.0, is_train=is_train)
    cpu = preprocess_batch(raw, noise=noise, **kw)
    card = preprocess_batch({k: v.to(cuda_device) for k, v in raw.items()},
                            noise=None if noise is None else noise.to(cuda_device), **kw)
    assert card["rgb"].device.type == "cuda" and card["rgb"].shape == (4, 128, 128, 3)
    torch.testing.assert_close(card["rgb"].cpu(), cpu["rgb"], rtol=0, atol=2e-4)
    for k in ("hm_hand", "hm_obj"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=0, atol=1e-5)


def test_force_optim_on_the_card_matches_the_cpu(cuda_device):
    """``optimize_forces`` (10 + 40 iterations, bs 8, TF32 off) on the card against the port on
    the CPU, on the CPU parity bars of ``tests/test_torch_port_force.py``: forces within rtol
    1e-4 / atol 1e-5, the final losses within rtol 1e-4.  A sample without contact gets 0."""
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine import force_optim as FO
    from vpho_tpu_torch.models import vpho as V

    ctx = V.make_context(V.ModelConfig(), device="cpu")
    arrays = fixtures.make_arrays(ctx, seed=5, batch_size=8, patch_size=64)
    contact = (np.abs(np.random.RandomState(6).randn(8, 32)) * 0.5).astype(np.float32)
    contact[3] = 0.0
    inputs = [torch.from_numpy(a) for a in (contact, arrays["gt_hand_vert_flip"],
                                            arrays["gravity"], arrays["obj_CoM"])]
    cpu = FO.optimize_forces(*inputs, ctx.anchor_tables, iters_phase1=10, iters_total=50)
    tables = type(ctx.anchor_tables)(*[t.to(cuda_device) for t in ctx.anchor_tables])
    card = FO.optimize_forces(*[t.to(cuda_device) for t in inputs], tables, iters_phase1=10,
                              iters_total=50)
    for k in ("force_local", "force_point", "force_global"):
        assert card[k].device.type == "cuda"
        np.testing.assert_allclose(card[k].cpu().numpy(), cpu[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k, v in cpu["losses"].items():
        np.testing.assert_allclose(card["losses"][k].item(), v.item(), rtol=1e-4, err_msg=k)
    assert (card["force_local"][3] == 0).all()


def test_nccl_world_of_one_matches_the_undistributed_step(cuda_device, tmp_path):
    """``Trainer.train_step`` run eagerly in an nccl process group of one rank (the gradients
    through the NCCL all-reduce, batch norm through its cross-rank path) against
    the same step with no process group, TF32 off, with ``test_torch_port_train``'s bars: loss
    terms rtol 1e-4; gradients per parameter rtol 1e-3 (heads), 1e-2 (denoisers), 0.15 (trunk:
    train-mode BN at bs 4 is ill-conditioned, and the two paths sum in other orders) plus
    1e-4 x the module's largest gradient norm; BN statistics 1e-3 x their largest value."""
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer, _split_state
    from vpho_tpu_torch.models.layers import DropoutMasks
    from vpho_tpu_torch.parallel import mesh

    cfg = get_config(["--mode", "train", "--batch_size", "4", "--patch_size", "64",
                      "--repeat_num", "2", "--output_dir", str(tmp_path)])
    gen = torch.Generator().manual_seed(0)
    masks = [torch.rand(s, generator=gen) < 0.9 for s in
             [(4, 65, 512), (1, 1, 65, 65), (4, 65, 512), (4, 65, 2048), (4, 65, 512)] * 2]
    draws = {"hand": (torch.rand(8, 1, generator=gen) * 0.99 + 0.01, torch.randn(8, 96, generator=gen)),
             "obj": (torch.rand(8, 1, generator=gen) * 0.99 + 0.01, torch.randn(8, 9, generator=gen))}
    runs, sd = [], None
    for distributed in (False, True):
        if distributed:
            mesh.init_distributed(torch.device("cuda", 0), backend="nccl", world=1, rank_=0,
                                  init_method=f"tcp://localhost:{mesh.free_port()}")
        try:
            trainer = Trainer(cfg, cuda_device)
            trainer.init_state(8)
            if sd is None:
                sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            trainer.model.load_state_dict(sd)
            batch = fixtures.make_batch(trainer.ctx, seed=0, batch_size=4, patch_size=64)
            seen, step = {}, trainer.optimizer.step
            trainer.optimizer.step = lambda g: (seen.setdefault("g", [x.clone() for x in g]),
                                                step(g))[1]
            losses = trainer.train_step(
                batch, draws={k: (a.cuda(), b.cuda()) for k, (a, b) in draws.items()},
                dropout=DropoutMasks(masks=[m.cuda() for m in masks], rows=mesh.batch_rows(4)),
                eager=True)
            stats = {k: v for k, v in _split_state(trainer.model)["batch_stats"].items()
                     if "running" in k}
            runs.append((losses, dict(zip(trainer.optimizer.names, seen["g"])), stats))
        finally:
            mesh.shutdown()
    (l0, g0, s0), (l1, g1, s1) = runs
    for k in l0:
        np.testing.assert_allclose(l1[k].item(), l0[k].item(), rtol=1e-4, err_msg=k)
    scale = {}
    for k, g in g0.items():
        scale[k.split(".")[0]] = max(scale.get(k.split(".")[0], 0.0), g.norm().item())
    heads = ("head_mano", "cross_hand", "cross_obj", "head_physics")
    for k, g in g0.items():
        grp = k.split(".")[0]
        rtol = 1e-3 if grp in heads else 1e-2 if grp.startswith("denoiser") else 0.15
        assert (g1[k] - g).norm().item() <= rtol * g.norm().item() + 1e-4 * scale[grp], k
    for k, v in s0.items():
        assert (s1[k] - v).abs().max().item() <= 1e-3 * v.abs().max().item(), k


def _small_predict(device, dtype):
    """A test-size model (patch 64, bs 2, S 4, 5 dpm3m steps, topk 3/2), a fixture batch and
    an ODE start state, on ``device``."""
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.models import vpho as V

    cfg = V.ModelConfig(patch_size=64, sample_num=4, sampling_steps=5, topk_hand=3, topk_obj=2,
                        compute_dtype=dtype)
    ctx = V.make_context(cfg, device=device)
    model = V.build_model(cfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():                    # a non-zero score: the last bank layers drawn
        for den in (model.denoiser_hand, model.denoiser_obj):
            for t in (den.head.head[2].weight, den.head.head[2].bias):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
    batch = fixtures.make_batch(ctx, seed=2, batch_size=2, patch_size=64)
    x0s = [V.draw_x0(ctx, 2, torch.Generator().manual_seed(s)) for s in (3, 4)]
    return V, ctx, model, batch, x0s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_and_candidate_steps_replay_the_eager_run(cuda_device, dtype):
    """TF32 off: a replay of ``make_predict_step`` and of ``make_candidate_step`` equals
    ``forward_predict`` / ``forward_candidates`` run eagerly, bit for bit, for the x0 it was
    captured with and for another one (the replay reads its static buffers); the capture (under
    ``set_sync_debug_mode("error")``) raises nothing; one graph for the signature.  cuDNN's
    deterministic algorithms: in float32 its transposed convolution (the heatmap heads'
    deconvolutions) may sum with atomics, and then two eager runs differ too."""
    from vpho_tpu_torch.engine.trainer import make_candidate_step, make_predict_step

    V, ctx, model, batch, x0s = _small_predict(cuda_device, dtype)
    predict, candidates = make_predict_step(model, ctx), make_candidate_step(model, ctx)
    torch.backends.cudnn.deterministic = True
    try:
        _replay_the_eager_run(V, ctx, model, batch, x0s, predict, candidates)
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(predict.graphs) == len(candidates.graphs) == 1


def _replay_the_eager_run(V, ctx, model, batch, x0s, predict, candidates):
    for x0 in x0s:
        eager = V.forward_predict(model, ctx, batch, x0=x0)
        got = predict(batch, x0)
        assert set(got) == set(eager)
        for k, v in eager.items():
            assert torch.equal(got[k], v), k
        eager_c = V.forward_candidates(model, ctx, batch, x0=x0)[0]
        got_c = candidates(batch, x0)
        for k, v in eager_c.items():
            assert torch.equal(got_c[k], v), k


def test_predict_graph_times_its_stages_on_every_replay(cuda_device):
    """The predict graph's stage marks are event nodes, recorded again by every replay: after
    each call the launch wait, trunk, ODE and aggregation read positive, and together no more
    than events recorded around the call.  The eager warm-up takes the same marks; the
    candidate step, which runs the same ``forward_candidates``, captures none."""
    from vpho_tpu_torch.engine.trainer import make_candidate_step, make_predict_step
    from vpho_tpu_torch.utils import marks as M

    V, ctx, model, batch, x0s = _small_predict(cuda_device, "bfloat16")
    step = make_predict_step(model, ctx)
    keys = [key for key, _, _ in M.STAGES]
    step.eager(cuda_device, batch, x0s[0])
    torch.cuda.synchronize()
    assert list(M.stage_seconds(step.marks)) == keys
    step.capture(batch, x0s[0], warm=False)
    (_, graph), = step.graphs.values()
    assert list(graph.marks) == ["start", "trunk", "ode", "end"]
    clock = M.Clock(cuda_device)
    for i in range(4):
        before = clock.mark()
        step(batch, x0s[i % 2])
        after = clock.mark()
        torch.cuda.synchronize()
        got = M.stage_seconds(step.marks)
        assert list(got) == keys
        assert all(v > 0.0 for v in got.values()), got
        assert sum(got.values()) <= clock.seconds(before, after), got
    candidates = make_candidate_step(model, ctx)
    candidates.capture(batch, x0s[0])
    (_, graph), = candidates.graphs.values()
    assert graph.marks == {}
    candidates(batch, x0s[1])
    assert candidates.marks == {}


def test_kernel_tallies_count_replayed_launches(cuda_device):
    """bf16 (K1 is the bf16 hand head's fast path): after the capture, n replays move K1's
    launches by n x the ODE's score evaluations, K2's by 2n (stages 4 and 5) and K4's by n x
    the trunk's BN sites, each ``operations`` tally by n x a batch's and K4's ``bytes_moved``
    by n x a batch's."""
    from vpho_tpu_torch.diffusion.sampler import score_evals
    from vpho_tpu_torch.engine.trainer import make_predict_step

    V, ctx, model, batch, x0s = _small_predict(cuda_device, "bfloat16")
    step = make_predict_step(model, ctx)
    k1_0, k2_0, k4_0 = K1.operations, K2.operations, K4.bytes_moved
    V.forward_predict(model, ctx, batch, x0=x0s[0])
    per_batch = (K1.operations - k1_0, K2.operations - k2_0, K4.bytes_moved - k4_0)
    assert per_batch[0] > 0 and per_batch[1] > 0 and per_batch[2] > 0
    step.capture(batch, x0s[0])                       # warm-up (counted) and capture (not)
    K1.launches = K2.launches = K4.launches = K1.operations = K2.operations = K4.bytes_moved = 0
    n = 3
    for i in range(n):
        step(batch, x0s[i % 2])
    torch.cuda.synchronize()
    assert K1.launches == n * score_evals("dpm3m", 5)
    assert K2.launches == 2 * n
    assert K4.launches == n * trunk_sites(model)
    assert (K1.operations, K2.operations, K4.bytes_moved) == tuple(n * v for v in per_batch)


def test_capture_refuses_a_host_wait(cuda_device):
    """A step that reads a value back to the host cannot be captured: the capture raises
    (``set_sync_debug_mode("error")``) and says so, and the tallies are left as they were."""
    from vpho_tpu_torch.engine.graphs import CapturedStep

    x = torch.arange(4.0, device=cuda_device)
    before = (K1.launches, K2.launches)
    step = CapturedStep(lambda t: t * float(t.sum()), "waits")
    with pytest.raises(RuntimeError, match="waits: CUDA graph capture failed"):
        step(x)
    assert (K1.launches, K2.launches) == before and not step.graphs


def test_force_graphs_replay_the_eager_loop(cuda_device):
    """bs 8, 10 + 40 iterations, TF32 off: ``optimize_forces`` on graphs (one per phase,
    replayed) equals the same iteration functions run eagerly on the card, bit for bit, twice
    through the cached loop; no kernel launched."""
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine import force_optim as FO
    from vpho_tpu_torch.models import vpho as V

    ctx = V.make_context(V.ModelConfig(), device=cuda_device)
    arrays = fixtures.make_arrays(V.make_context(V.ModelConfig(), device="cpu"), seed=5,
                                  batch_size=8, patch_size=64)
    contact = (np.abs(np.random.RandomState(6).randn(8, 32)) * 0.5).astype(np.float32)
    inputs = [torch.from_numpy(a).to(cuda_device) for a in
              (contact, arrays["gt_hand_vert_flip"], arrays["gravity"], arrays["obj_CoM"])]
    before = (K1.launches, K2.launches)
    for _ in range(2):
        eager = FO.optimize_forces(*inputs, ctx.anchor_tables, 10, 50, graphs=False)
        graphs = FO.optimize_forces(*inputs, ctx.anchor_tables, 10, 50)
        for k in ("force_local", "force_point", "force_global"):
            assert torch.equal(graphs[k], eager[k]), k
    assert FO._LOOPS[(8, inputs[0].device, 50)].graphs is not None
    assert (K1.launches, K2.launches) == before


# ---- the train step, the metrics and the preprocess as graphs ------------------------------

TRAIN_ARGV = ["--mode", "train", "--batch_size", "4", "--patch_size", "64", "--repeat_num", "2",
              "--gradient_clip", "1e-3", "--gradient_accumulation_steps", "2", "--scheduler",
              "exp", "--gamma", "0.5"]


def _train_state(trainer):
    """The tensors a train call moves, by kind."""
    opt = trainer.optimizer
    return {"params": opt.params, "moments": opt.mu + opt.nu, "acc": opt.acc,
            "bn": [b for b in trainer.model.buffers() if b.is_floating_point()]}


def _four_calls(device, tmp_path, sd, eager):
    """4 ``Trainer.train_step`` calls on one batch from the weights ``sd``, the randomness from
    a generator seeded 7; returns the losses and the moved state, on the host."""
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(get_config(TRAIN_ARGV + ["--output_dir", str(tmp_path)]), device)
    trainer.init_state(1)
    trainer.model.load_state_dict(sd)
    batch = fixtures.make_batch(trainer.ctx, seed=0, batch_size=4, patch_size=64)
    gen = torch.Generator(device).manual_seed(7)
    k4 = K4.launches
    losses = [trainer.train_step(batch, generator=gen, eager=eager) for _ in range(4)]
    torch.cuda.synchronize()
    assert K4.launches == k4                 # train mode keeps the plain chain
    if not eager:
        step = trainer._step("train")
        assert len(step.graph.graphs) == 1 and step.apply_graph is not None
    state = {k: [t.detach().cpu().clone() for t in v] for k, v in _train_state(trainer).items()}
    state["losses"] = [torch.stack([v.float() for v in call.values()]).cpu() for call in losses]
    return state


def _rel(a, b):
    return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
               for x, y in zip(a, b))


def _replays_hold_to_the_eager_noise(device, tmp_path):
    """Two eager runs and one run on graphs from the same state: the graphs equal the first
    eager run bit for bit where the two eager runs agree bit for bit; where they do not (a
    backward summing with atomics), each kind of state within 4x the eager runs' largest
    relative difference of that kind.  Returns {kind: (eager noise, graphs' difference)}."""
    from vpho_tpu_torch.models import vpho as V

    sd = V.build_model(V.ModelConfig(patch_size=64, repeat_num=2), seed=3,
                       device=device).state_dict()
    e1, e2 = (_four_calls(device, tmp_path, sd, eager=True) for _ in range(2))
    g = _four_calls(device, tmp_path, sd, eager=False)
    out = {}
    for kind in e1:
        noise, got = _rel(e2[kind], e1[kind]), _rel(g[kind], e1[kind])
        out[kind] = (noise, got)
        assert got <= 4 * noise, (kind, noise, got)
    return out


def test_train_step_replays_equal_eager_steps(cuda_device, tmp_path):
    """bs 4, patch 64, f32, TF32 off, cuDNN deterministic; the clip binds, MultiSteps over 2
    calls, ``exp`` at one step an epoch (every update its own learning rate): 4 calls on
    ``make_train_step``'s graphs (call 1 the warm-up and capture, 2-4 replays; the update's
    graph captured at call 2 and replayed at 4) against 4 eager calls, losses, parameters, Adam
    moments, accumulator and BN statistics (``_replays_hold_to_the_eager_noise``)."""
    torch.backends.cudnn.deterministic = True
    try:
        _replays_hold_to_the_eager_noise(cuda_device, tmp_path)
    finally:
        torch.backends.cudnn.deterministic = False


def test_train_step_captured_in_an_nccl_world_of_one(cuda_device, tmp_path):
    """The same 4 calls in an nccl process group of one rank: the cross-rank batch norm's and
    the gradients' NCCL all-reduces are captured in the graph, and the replays hold to the
    eager steps in that group as above."""
    from vpho_tpu_torch.engine import graphs as G
    from vpho_tpu_torch.parallel import mesh

    mesh.init_distributed(torch.device("cuda", 0), backend="nccl", world=1, rank_=0,
                          init_method=f"tcp://localhost:{mesh.free_port()}")
    torch.backends.cudnn.deterministic = True
    try:
        assert G.capturable(cuda_device)
        _replays_hold_to_the_eager_noise(cuda_device, tmp_path)
    finally:
        torch.backends.cudnn.deterministic = False
        mesh.shutdown()


def test_metric_and_preprocess_replays_equal_eager_runs(cuda_device, tmp_path):
    """``hand_metrics``, ``object_metrics`` and the eval and train device preprocess as graphs
    (two replays each, on other inputs than the capture's) equal the functions run eagerly,
    bit for bit."""
    from vpho_tpu_torch.configs.config import Config
    from vpho_tpu_torch.data import dexycb as D
    from vpho_tpu_torch.data.device_pipeline import (draw_erase_noise, make_device_preprocess,
                                                     preprocess_batch)
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb
    from vpho_tpu_torch.engine import metrics as M
    from vpho_tpu_torch.engine import tester as TE
    from vpho_tpu_torch.models import vpho as V
    from vpho_tpu_torch.utils import transforms as TR

    reg = V.make_context(V.ModelConfig(), device=cuda_device).registry
    rng = np.random.RandomState(0)
    for seed in range(3):
        f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05 + [0, 0, 0.6]).astype(np.float32)
                                        ).to(cuda_device)
        hand = (f(8, 21, 3), f(8, 21, 3), f(8, 778, 3), f(8, 778, 3))
        R = TR.axis_angle_to_matrix(torch.from_numpy(rng.randn(2, 8, 3).astype(np.float32)))
        rts = [torch.cat([r.to(cuda_device), f(8, 3)[..., None]], -1) for r in R]
        ids = torch.from_numpy(rng.randint(0, 21, 8).astype(np.int32)).to(cuda_device)
        K = torch.tensor([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]],
                         device=cuda_device).repeat(8, 1, 1)
        for got, ref in ((TE.HAND_METRICS(*hand), M.hand_metrics(*hand)),
                         (TE.object_metrics_step(reg)(*rts, ids, K),
                          M.object_metrics(reg, *rts, ids, K))):
            assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    root = build_mini_dexycb(str(tmp_path), n=8, seed=3, sides=["right", "left"] * 4)
    cfg = Config(data_dir=root, patch_size=128, device_preprocess=True)
    for is_train in (False, True):
        ds = D.DexYCBForceDataset(cfg, root, is_train=is_train)
        pre = make_device_preprocess(cfg, is_train)
        for lo in (0, 4, 0):
            raw = {k: torch.as_tensor(v).to(cuda_device)
                   for k, v in D.collate([ds[i] for i in range(lo, lo + 4)]).items()}
            noise = draw_erase_noise(raw, 128, cfg.random_erasing_mode,
                                     torch.Generator(cuda_device).manual_seed(lo)) \
                if is_train else None
            got = pre(raw, noise=noise)
            ref = preprocess_batch(raw, 128, cfg.heatmap_size, cfg.heatmap_hand_sigma,
                                   cfg.heatmap_obj_sigma, is_train, cfg.random_erasing_mode,
                                   noise=noise)
            assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_train_capture_refuses_a_host_wait(cuda_device, tmp_path, monkeypatch):
    """A train step that reads a value back to the host (here the physics losses, patched to
    read their sum) is refused at its warm-up under ``set_sync_debug_mode("error")``, and the
    error names the port's line that made the call."""
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.data import fixtures
    from vpho_tpu_torch.engine.trainer import Trainer
    from vpho_tpu_torch.models import heads

    real = heads.physics_losses

    def reads_back(*args):
        out = real(*args)
        float(sum(out.values()))
        return out

    monkeypatch.setattr(heads, "physics_losses", reads_back)
    trainer = Trainer(get_config(TRAIN_ARGV + ["--output_dir", str(tmp_path)]), cuda_device)
    trainer.init_state(1)
    batch = fixtures.make_batch(trainer.ctx, seed=0, batch_size=4, patch_size=64)
    with pytest.raises(RuntimeError, match=r"train_step: CUDA graph warm-up failed at "
                                           r"models/vpho\.py:\d+ `.*physics_losses"):
        trainer.train_step(batch, generator=torch.Generator(cuda_device).manual_seed(0))
