"""The hand-written CUDA kernels (K1 bank-MLP, K2 nearest-vertex search) against their plain
PyTorch versions on the card, one training step on the card, and the device preprocess
(``--device_preprocess``) on the card against itself on the CPU.

There is no CPU mode for a CUDA kernel, so every test here needs an NVIDIA GPU and skips
without one.  This file imports neither jax nor ``vpho_tpu``, so on a machine with a card and
no JAX it runs alone, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from vpho_tpu_torch.ops import bank_mlp as K1
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
