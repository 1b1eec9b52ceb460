"""The hand-written CUDA kernels (K1 bank-MLP, K2 nearest-vertex search) against their plain
PyTorch versions on the card.

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
    d_ref, i_ref = K2.min_dist_plain(torch.from_numpy(fp), torch.from_numpy(verts))
    np.testing.assert_allclose(d.cpu().numpy(), d_ref.numpy(), rtol=0, atol=1e-5)
    assert_argmin_equivalent(fp, verts, i.cpu().numpy(), i_ref.numpy())
