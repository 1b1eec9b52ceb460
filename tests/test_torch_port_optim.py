"""The training slice's pieces that need no model, against the JAX package: the learning-rate
schedules, the optimizers on identical gradients (AdamW, L2-coupled Adam, the global-norm clip,
``optax.MultiSteps`` accumulation and its schedule count), the EMA, train-mode batch norm on one
layer, the dropout sites, the loss functions on identical inputs, and the weights round trip.

Bars: schedules rtol 1e-6 (both in float32); optimizer updates rtol 1e-5; the rest as stated
at each test.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vpho_tpu.configs.config import Config as JaxConfig
from vpho_tpu.diffusion import sampler as JS
from vpho_tpu.diffusion.sde import init_sde as jax_init_sde
from vpho_tpu.engine import trainer as JT
from vpho_tpu.models import ema as JEMA
from vpho_tpu.models import heads as JH
from vpho_tpu.models.layers import TorchBatchNorm, joints_mse_loss as jax_joints_mse
from vpho_tpu.utils import hand as JHAND
from vpho_tpu_torch.configs.config import Config
from vpho_tpu_torch.diffusion import sampler as TS
from vpho_tpu_torch.diffusion.sde import init_sde
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.models import ema as TEMA
from vpho_tpu_torch.models import heads as TH
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.models.layers import BatchNorm2d, DropoutMasks, joints_mse_loss
from vpho_tpu_torch.utils import hand as THAND
from vpho_tpu_torch.utils.weights import jax_variables_from_state_dict, state_dict_from_jax

torch.set_num_threads(1)

SHAPES = {"conv": (3, 3, 4, 8), "dense": (16, 5), "bias": (5,), "bank": (2, 6, 3)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg(**kw):
    """The same settings as the JAX package's Config and the port's."""
    return JaxConfig(**kw), Config(**kw)


@pytest.mark.parametrize("kw", [dict(scheduler="exp", gamma=0.9),
                                dict(scheduler="step", gamma=0.5, lr_step=2),
                                dict(scheduler="cosine", max_epochs=7)],
                         ids=["exp", "step", "cosine"])
def test_schedules_match_jax(kw):
    jcfg, tcfg = _cfg(base_learning_rate=3e-4, **kw)
    ref, got = JT.make_lr_schedule(jcfg, 5), TT.make_lr_schedule(tcfg, 5)
    for step in range(0, 45):
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))), rtol=1e-6,
                                   err_msg=f"step {step}")


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng):
    # mixed scales (and exact zeros) so the clip, the decay and Adam's eps all matter
    return {k: (rng.randn(*s) * 10.0 ** rng.uniform(-6, 1, s) * (rng.rand(*s) > 0.1)
                ).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("kw", [dict(optimizer="adamw"),
                                dict(optimizer="adam"),
                                dict(optimizer="adamw", gradient_clip=0.5, scheduler="cosine",
                                     max_epochs=2),
                                dict(optimizer="adam", gradient_clip=0.5),
                                dict(optimizer="adamw", gradient_accumulation_steps=3,
                                     scheduler="exp", gamma=0.5),
                                dict(optimizer="adam", gradient_accumulation_steps=2,
                                     gradient_clip=0.1, scheduler="step", gamma=0.5, lr_step=1)],
                         ids=["adamw", "adam", "adamw_clip_cosine", "adam_clip",
                              "adamw_multisteps3", "adam_multisteps2_clip"])
def test_optimizer_matches_optax(kw):
    """The port's optimizer against the JAX trainer's optax chain on identical gradients:
    each applied update (read as the parameters' change, so to within the parameters' own
    float32 spacing) within rtol 1e-5, the parameters unmoved between accumulation
    boundaries, and the schedule stepping on applied updates only (with MultiSteps the epoch
    of ``exp``/``step`` counts updates, not mini-batches).  ``Optimizer.updates`` itself is
    held without that spacing in ``test_optimizer_updates_exact_against_optax``."""
    jcfg, tcfg = _cfg(base_learning_rate=1e-2, **kw)
    spe = 2
    tx, _ = JT.make_optimizer(jcfg, spe)
    jp = jax.tree.map(jnp.asarray, _params(0))
    st = tx.init(jp)
    tp = {k: _t(v) for k, v in _params(0).items()}
    opt = TT.make_optimizer(tcfg, tp, spe)
    rng = np.random.RandomState(1)
    k = max(tcfg.gradient_accumulation_steps, 1)
    for call in range(4 * k + 1):
        g = _grads(rng)
        up, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, up)
        before = {n: v.clone() for n, v in tp.items()}
        moved = opt.step([_t(g[n]) for n in opt.names])
        assert moved == ((call + 1) % k == 0), call
        for n in opt.names:
            ref = np.asarray(up[n])
            got = (tp[n] - before[n]).numpy() if moved else np.zeros_like(ref)
            if not moved:
                np.testing.assert_array_equal(tp[n].numpy(), before[n].numpy())
                np.testing.assert_array_equal(ref, 0.0)
            else:
                spacing = 2 * np.spacing(np.abs(before[n].numpy()).max())
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=spacing,
                                           err_msg=f"{n} {call}")
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
    assert opt.count == (4 * k + 1) // k


def test_optimizer_updates_exact_against_optax():
    """``Optimizer.updates`` itself (not a parameter difference, which rounds) on identical
    gradients and parameters, two AdamW steps on the cosine warm-up: rtol 1e-5."""
    jcfg, tcfg = _cfg(optimizer="adamw", scheduler="cosine", max_epochs=3,
                      base_learning_rate=2e-4)
    tx, _ = JT.make_optimizer(jcfg, 4)
    p = _params(2)
    st = tx.init(jax.tree.map(jnp.asarray, p))
    opt = TT.make_optimizer(tcfg, {k: _t(v) for k, v in p.items()}, 4)
    rng = np.random.RandomState(3)
    for _ in range(2):
        g = _grads(rng)
        up, st = tx.update(jax.tree.map(jnp.asarray, g), st, jax.tree.map(jnp.asarray, p))
        got = opt.updates([_t(g[n]) for n in opt.names])
        for n, u in zip(opt.names, got):
            np.testing.assert_allclose(u.numpy(), np.asarray(up[n]), rtol=1e-5, atol=0)


def test_adam_is_torch_adam_with_l2():
    """'adam' is ``torch.optim.Adam(weight_decay=5e-4)`` (the decay coupled into the gradient),
    as tests/test_engine.py pins for the JAX package."""
    _, tcfg = _cfg(optimizer="adam", base_learning_rate=0.1, scheduler="exp", gamma=1.0)
    w = torch.tensor([1.0, -0.5])
    opt = TT.make_optimizer(tcfg, {"w": w}, 1)
    ref = torch.nn.Parameter(torch.tensor([1.0, -0.5]))
    topt = torch.optim.Adam([ref], lr=0.1, weight_decay=5e-4)
    for g in ([0.0, 0.0], [0.3, -2.0], [0.0, 1e-3]):
        opt.step([torch.tensor(g)])
        ref.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(w.numpy(), ref.detach().numpy(), rtol=1e-5)


def test_optimizer_state_round_trip():
    _, tcfg = _cfg(optimizer="adamw", gradient_accumulation_steps=2)
    p = {k: _t(v) for k, v in _params(4).items()}
    opt = TT.make_optimizer(tcfg, p, 3)
    rng = np.random.RandomState(5)
    for _ in range(3):
        opt.step([_t(_grads(rng)[n]) for n in opt.names])
    other = TT.make_optimizer(tcfg, {k: v.clone() for k, v in p.items()}, 3)
    other.load_state_dict(opt.state_dict())
    assert (other.count, other.mini_step) == (1, 1)
    for a, b in zip(opt.mu + opt.nu + opt.acc, other.mu + other.nu + other.acc):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="accumulation"):
        TT.make_optimizer(dataclasses.replace(tcfg, gradient_accumulation_steps=1), p,
                          3).load_state_dict(opt.state_dict())


def test_ema_matches_jax():
    p0 = _params(6)
    jst = JEMA.ema_init(jax.tree.map(jnp.asarray, p0))
    tst = TEMA.ema_init({k: _t(v) for k, v in p0.items()})
    rng = np.random.RandomState(7)
    for _ in range(4):
        new = {k: v + rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        jst = JEMA.ema_update(jst, jax.tree.map(jnp.asarray, new), decay=0.99)
        tst = TEMA.ema_update(tst, {k: _t(v) for k, v in new.items()}, decay=0.99)
    assert tst.num_updates == int(jst.num_updates) == 4
    for k in p0:
        np.testing.assert_allclose(tst.params[k].numpy(), np.asarray(jst.params[k]), rtol=1e-6,
                                   atol=1e-7)
    live = {k: _t(v) for k, v in p0.items()}
    shadow, backup = TEMA.ema_swap(tst, live)
    assert shadow is tst.params and backup is live


def test_batchnorm_train_mode_matches_flax():
    """One train-mode batch norm against Flax's ``nn.BatchNorm(momentum=0.9)``: the output
    within rtol 1e-5 and the running statistics within 1e-6, the variance biased (torch's own
    ``nn.BatchNorm2d`` stores the unbiased one, off by n / (n - 1) = 8 / 7 here)."""
    rng = np.random.RandomState(8)
    x = (rng.randn(2, 6, 2, 2) * rng.uniform(0.1, 3, (1, 6, 1, 1))
         + rng.randn(1, 6, 1, 1)).astype(np.float32)
    mean0, var0 = rng.randn(6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(6)).astype(np.float32), rng.randn(6).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    y_ref, mut = TorchBatchNorm(use_running_average=False).apply(
        variables, jnp.transpose(x, (0, 2, 3, 1)), mutable=["batch_stats"])
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    y = bn.train()(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.transpose(np.asarray(y_ref), (0, 3, 1, 2)),
                               rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 0
    unbiased = 0.9 * var0 + 0.1 * x.var(axis=(0, 2, 3), ddof=1)
    assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-2
    # eval mode normalizes with the running statistics and leaves them alone
    before = bn.running_var.clone()
    bn.eval()(_t(x))
    assert torch.equal(bn.running_var, before)


def test_dropout_masks():
    """Rate 0.1: ~90% kept, kept values scaled by exactly 1 / 0.9 (float32), the rest 0; the
    attention-weight form draws one (q, k) mask shared by the batch and the heads; given masks
    replay in call order and a wrong shape or count raises."""
    x = torch.ones(400, 1000)
    drop = DropoutMasks(generator=torch.Generator().manual_seed(0))
    y = drop(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 3e-3
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / 0.9))
    w = torch.rand(3, 2, 5, 7)
    wd = drop.attention(w)
    m = drop.drawn[-1]
    assert m.shape == (1, 1, 5, 7)
    assert torch.equal(wd, w * (m.float() / 0.9))
    replay = DropoutMasks(masks=drop.drawn)
    assert torch.equal(replay(x), y) and torch.equal(replay.attention(w), wd)
    with pytest.raises(ValueError, match="asks for another"):
        replay(x)
    with pytest.raises(ValueError, match="mask"):
        DropoutMasks(masks=drop.drawn)(torch.ones(3))


def test_dropout_only_in_train_mode():
    layer = TV.heads.CrossModule(256, 512, spatial=64)
    rng = np.random.RandomState(9)
    xh, xo = (_t(rng.randn(2, 256, 8, 8).astype(np.float32)) for _ in range(2))
    g = _t(rng.randn(2, 1, 3).astype(np.float32))
    drop = DropoutMasks(generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = layer.eval()(xh, xo, g, drop)
        assert drop.drawn == []
        b = layer.train()(xh, xo, g, drop)
    # the five sites, in Flax's call order
    assert [tuple(m.shape) for m in drop.drawn] == [(2, 65, 512), (1, 1, 65, 65), (2, 65, 512),
                                                   (2, 65, 2048), (2, 65, 512)]
    assert not torch.allclose(a[0], b[0])


def test_loss_functions_match_jax():
    """The loss functions on identical inputs: rtol 1e-5."""
    rng = np.random.RandomState(10)
    r = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    B = 3
    is_right = np.array([True, False, True])
    args = (r(B, 48, sc=0.5), r(B, 10), r(B, 778, 3, sc=0.05), r(B, 21, 3, sc=0.05),
            r(B, 48, sc=0.5), r(B, 10), r(B, 778, 3, sc=0.05), r(B, 21, 3, sc=0.05))
    ref = JH.mano_losses(*args, is_right)
    got = TH.mano_losses(*map(_t, args), _t(is_right))
    phys = (r(B, 32, 3, sc=0.05), r(B, 32, 3), r(B, 1, 3, sc=0.05), r(B, 32, 3, sc=0.05),
            r(B, 32, 3, sc=0.1), r(B, 32, 3, sc=0.1), r(B, 1, 3))
    grasp = np.array([1.0, 0.0, 1.0], np.float32)
    ref.update(JH.physics_losses(*phys, grasp))
    got.update(TH.physics_losses(*map(_t, phys), _t(grasp)))
    hm = (r(B, 21, 8, 8), r(B, 21, 8, 8))
    ref["hm"], got["hm"] = jax_joints_mse(*hm), joints_mse_loss(*map(_t, hm))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_score_matching_loss_matches_jax():
    """The D7 score loss with JAX's own draws passed in, and a closed-form score function:
    rtol 1e-5; without draws it takes them from the generator."""
    rng = np.random.RandomState(11)
    B, D, R = 3, 9, 4
    feat, gt = rng.randn(B, 16).astype(np.float32), rng.randn(B, D).astype(np.float32)
    w = rng.randn(16, D).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(12)
    ref = JS.score_matching_loss(lambda f, x, t: -(x - f @ w) / (t + 0.1), key, feat, gt,
                                 jax_init_sde("ve"), R)
    k_t, k_z = jax.random.split(key)
    sde = init_sde("ve")
    random_t = jax.random.uniform(k_t, (R * B, 1)) * (1.0 - sde.eps) + sde.eps
    z = jax.random.normal(k_z, (R * B, D))
    tw = _t(w)
    fn = lambda f, x, t: -(x - f @ tw) / (t + 0.1)
    got = TS.score_matching_loss(fn, _t(feat), _t(gt), sde, R, random_t=_t(random_t), z=_t(z))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    drawn = TS.score_matching_loss(fn, _t(feat), _t(gt), sde, R,
                                   generator=torch.Generator().manual_seed(0))
    again = TS.score_matching_loss(fn, _t(feat), _t(gt), sde, R,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn) and torch.equal(drawn, again)


def test_ho3d_joint_alignment_matches_jax():
    rng = np.random.RandomState(13)
    vert, joint = rng.randn(2, 778, 3).astype(np.float32), rng.randn(2, 21, 3).astype(np.float32)
    for order in ("manopth", "manolayer"):
        np.testing.assert_array_equal(THAND.joint_reorder(_t(joint), order).numpy(),
                                      np.asarray(JHAND.joint_reorder(joint, order)))
    np.testing.assert_array_equal(THAND.get_joint_aligned_with_ho3d(_t(vert), _t(joint)).numpy(),
                                  np.asarray(JHAND.get_joint_aligned_with_ho3d(jnp.asarray(vert),
                                                                             jnp.asarray(joint))))


def test_weights_round_trip():
    """state_dict -> Flax trees -> state_dict is the identity on all 982 keys."""
    model = TV.build_model(TV.ModelConfig(), seed=14, device="cpu")
    with torch.no_grad():                 # BN statistics away from (0, 1)
        for k, v in model.state_dict().items():
            if "running" in k:
                v.uniform_(0.5, 1.5)
    sd = model.state_dict()
    tree = jax_variables_from_state_dict(sd)
    assert set(tree) == {"params", "batch_stats", "buffers"}
    back = state_dict_from_jax(tree)
    assert len(sd) == len(back) == 982
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_flax_dropout_is_the_reference_form():
    """The two Flax forms the port copies: ``nn.Dropout`` (select x / keep or 0) and the
    attention weights' multiplier; checked on Flax itself so a Flax change shows here."""
    x = jnp.ones((4, 5))
    y = nn.Dropout(0.1, deterministic=False).apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    vals = np.unique(np.asarray(y))
    np.testing.assert_allclose(vals, [0.0, np.float32(1.0) / np.float32(0.9)])
