"""The frozen reference equals the port on the CPU at a small size: the traffic generator, the
predict path, the training forward and gradients, and the metrics, from the benchmark's own
weights and inputs."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare, weights
from benchmark.reference.vpho_ref.engine import metrics as RM
from benchmark.reference.vpho_ref.models import vpho as RV
from benchmark.reference.vpho_ref.models.layers import DropoutMasks as RDropout
from benchmark.reference.vpho_ref.models.mano import load_mano
from benchmark.reference.vpho_ref.models.ycb import load_registry
from benchmark.traffic import generator as traffic

CPU = torch.device("cpu")
MODEL = dict(patch_size=64, sample_num=3, sampling_steps=2, topk_hand=2, topk_obj=2)


@pytest.fixture(scope="module")
def sd():
    return weights.make_state_dict(2 ** 31 + 3, CPU)


@pytest.fixture(scope="module")
def batch():
    mix = {"batch_size": 2, "pool": 1, "patch_size": 64, "heatmap_size": 64, "eval_keys": True}
    return traffic.make_pool(mix, 2 ** 31 + 3, load_mano(device="cpu"),
                             load_registry(device="cpu"))[0]


def test_traffic_is_the_ports_fixture():
    from vpho_tpu_torch.data.fixtures import make_arrays
    from vpho_tpu_torch.models import vpho as V

    ctx = V.make_context(V.ModelConfig(patch_size=64), device=CPU)
    ours = traffic.make_arrays(load_mano(device="cpu"), load_registry(device="cpu"), 123, 2, 64, 64)
    theirs = make_arrays(ctx, 123, 2, 64, 64)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_predict_equals_the_port(sd, batch, dtype):
    from vpho_tpu_torch.models import vpho as V

    cfg = dict(MODEL, compute_dtype=dtype)
    port_ctx = V.make_context(V.ModelConfig(**cfg), device=CPU)
    port = V.build_model(V.ModelConfig(**cfg), seed=0, device=CPU)
    port.load_state_dict(sd, strict=True)
    ref = compare.reference_model(sd, dtype, CPU)
    ref_ctx = compare.reference_context(cfg, CPU)
    b = compare.to_device(batch, CPU)
    x0 = torch.randn(2 * 3, 105, generator=torch.Generator().manual_seed(4))
    got = V.forward_predict(port, port_ctx, b, x0=x0)
    want = RV.forward_predict(ref, ref_ctx, b, x0=x0)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_train_forward_and_gradients_equal_the_port(sd, batch):
    from vpho_tpu_torch.models import vpho as V
    from vpho_tpu_torch.models.layers import DropoutMasks

    cfg = dict(MODEL, compute_dtype="float32", repeat_num=2)
    port_ctx = V.make_context(V.ModelConfig(**cfg), device=CPU)
    port = V.build_model(V.ModelConfig(**cfg), seed=0, device=CPU)
    port.load_state_dict(sd, strict=True)
    ref = compare.reference_model(sd, "float32", CPU)
    ref_ctx = compare.reference_context(cfg, CPU)
    b = compare.to_device(batch, CPU)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    t1, l1 = V.forward_train(port, port_ctx, b, dropout=DropoutMasks(generator=g1), generator=g1)
    t2, l2 = RV.forward_train(ref, ref_ctx, b, dropout=RDropout(generator=g2), generator=g2)
    for k in l2:
        torch.testing.assert_close(l1[k], l2[k], rtol=0, atol=0, msg=k)
    ga = torch.autograd.grad(t1, list(port.parameters()), allow_unused=True)
    gb = torch.autograd.grad(t2, list(ref.parameters()), allow_unused=True)
    for (name, _), a, r in zip(port.named_parameters(), ga, gb):
        assert (a is None) == (r is None), name
        if a is not None:
            torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-9, msg=name)


def test_metrics_equal_the_port(batch):
    from vpho_tpu_torch.engine import metrics as M
    from vpho_tpu_torch.models.ycb import load_registry as port_registry

    b = compare.to_device(batch, CPU)
    noise = torch.randn(b["gt_joint"].shape, generator=torch.Generator().manual_seed(1))
    pj = b["gt_joint"] + 0.01 * noise
    pv = b["gt_hand_vert"] + 0.01
    got, want = M.hand_metrics(b["gt_joint"], pj, b["gt_hand_vert"], pv), \
        RM.hand_metrics(b["gt_joint"], pj, b["gt_hand_vert"], pv)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    rt = b["gt_obj_rt"].clone()
    rt[:, :, 3] += 0.02
    args = (rt, b["gt_obj_rt"], b["obj_id"], b["cam_intr"])
    got = M.object_metrics(port_registry(device=CPU), *args)
    want = RM.object_metrics(load_registry(device=CPU), *args)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
