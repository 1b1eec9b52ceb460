"""One training step of the port against the JAX package: ``forward_train``'s loss terms, the
gradients of every parameter, the BN statistics after the step, one full ``train_step`` with
AdamW and one with L2-coupled Adam and a clip, and ``final_model.pkl`` read back by JAX.

Size: bs 2, patch 64, repeat_num 2.  The weights are the port's seeded init (the JAX package's
scheme), carried to Flax by ``jax_variables_from_state_dict``, with the denoisers' last layer
made non-zero so the score loss reaches every denoiser weight.  The JAX step runs once,
jitted, in a module fixture; its score-loss draws come from its own keys
(``split(fold_in(PRNGKey(1000), 0), 3)``, as the JAX trainer derives them) and its dropout
masks are recorded as Flax draws them; both are passed to the port.

Bars (float32 on both sides):
  * loss terms rtol 1e-4;
  * gradients, per parameter, |g_port - g_jax| <= rtol |g_jax| + 1e-4 x (the largest
    gradient norm in the parameter's module), with rtol 1e-3 for the heads after the
    encoders (``head_mano``, ``cross_*``, ``head_physics``; met: 1.5e-4), 1e-2 for the
    denoisers (met: 6.4e-3) and 0.15 for the trunk (``feature_extractor``, ``head_hm_*``,
    ``encoder_*``; met: 0.104).  The trunk is ill-conditioned in train mode: batch-statistic
    BN makes many of its gradients near-cancelling sums, so changing the input image by one
    float32 ulp moves them by 2-4% in the port alone, and independent rounding in the two
    implementations puts them 5-10% apart.  Through the trunk's ~1e-4 difference a hidden unit
    of a denoiser bank that sits within 5e-5 of zero flips, which moves the denoisers'
    gradients by up to ~6e-3 (given the same features they agree within 4e-7).  The absolute
    term covers the conv biases that feed a train-mode BN, whose exact gradient is zero;
  * BN statistics after the step, per tensor, max |diff| <= 1e-3 x max |value| (met: 2.4e-4);
  * the optimizer on the JAX gradients, all parameters: updates rtol 1e-5, with an absolute
    floor of 1e-3 x the largest update of the tensor (Adam's first step is lr g / (|g| + eps):
    where L2-coupled decay nearly cancels a clipped gradient, the rounding of g moves the
    update by up to lr x ulp / eps, ~3e-3 lr);
  * FPN outputs of ``final_model.pkl`` read by the JAX package's ``--pretrain``: rtol 1e-3.
"""
import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.configs.config import Config as JaxConfig
from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import trainer as JT
from vpho_tpu.models import vpho as JV
from vpho_tpu.utils.torch_import import load_pretrain
from vpho_tpu_torch.configs.config import Config
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.models.layers import DropoutMasks
from vpho_tpu_torch.utils.weights import (jax_variables_from_state_dict, save_final_model,
                                          state_dict_from_jax)

torch.set_num_threads(1)

CFG = dict(repeat_num=2, patch_size=64)
HEADS = ("head_mano", "cross_hand", "cross_obj", "head_physics")
DENOISERS = ("denoiser_hand", "denoiser_obj")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_model():
    model = TV.build_model(TV.ModelConfig(**CFG), seed=3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for den in (model.denoiser_hand, model.denoiser_obj):
            l2 = den.head.head[2]
            l2.weight.copy_(torch.randn(l2.weight.shape, generator=gen) * 0.01)
            l2.bias.copy_(torch.randn(l2.bias.shape, generator=gen) * 0.01)
    return model


def _score_draws(key, n, dim, eps):
    """The draws ``vpho_tpu.diffusion.sampler.score_matching_loss`` makes from ``key``."""
    k_t, k_z = jax.random.split(key)
    return (_t(jax.random.uniform(k_t, (n, 1)) * (1.0 - eps) + eps),
            _t(jax.random.normal(k_z, (n, dim))))


def _as_sd(tree, variables):
    """A Flax params-shaped tree (e.g. gradients) in the port's state_dict layout."""
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, tree),
                                "batch_stats": variables["batch_stats"],
                                "buffers": variables["buffers"]})


@pytest.fixture(scope="module")
def step():
    jctx = JV.make_context(JV.ModelConfig(**CFG))
    jbatch = jax_make_batch(jctx, jax.random.PRNGKey(8), 2, 64)
    model = _port_model()
    init_sd = copy.deepcopy(model.state_dict())
    variables = jax.tree.map(jnp.asarray, jax_variables_from_state_dict(init_sd))
    jmodel = JV.VPHONet()
    rng = jax.random.fold_in(jax.random.PRNGKey(1000), 0)

    masks = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None, **kw):
        m = bernoulli(key, p, shape, **kw)
        masks.append(m)
        return m

    def jax_step(params):
        masks.clear()

        def loss_fn(p):
            v = {"params": p, "batch_stats": variables["batch_stats"],
                 "buffers": variables["buffers"]}
            total, loss_dt, mutated = JV.forward_train(jmodel, v, jctx, jbatch, rng)
            return total, (loss_dt, mutated)

        (_, (loss_dt, mutated)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss_dt, mutated["batch_stats"], grads, list(masks)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", recording)
    try:
        j_loss, j_stats, j_grads, j_masks = jax.jit(jax_step)(variables["params"])
    finally:
        mp.undo()

    _, rng_hand, rng_obj = jax.random.split(rng, 3)
    eps = jctx.sde.eps
    draws = {"hand": _score_draws(rng_hand, 4, 96, eps), "obj": _score_draws(rng_obj, 4, 9, eps)}
    tctx = TV.make_context(TV.ModelConfig(**CFG), device="cpu")
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    j_masks = [_t(m) for m in j_masks]
    total, t_loss = TV.forward_train(model, tctx, tbatch, draws=draws,
                                     dropout=DropoutMasks(masks=j_masks))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return dict(jctx=jctx, jbatch=jbatch, jmodel=jmodel, variables=variables, init_sd=init_sd,
                j_loss=j_loss, j_stats=j_stats, j_grads=j_grads, masks=j_masks, draws=draws,
                tctx=tctx, tbatch=tbatch, model=model, t_loss=t_loss,
                t_grads={k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), grads)})


def test_flax_tree_matches_init(step):
    """The inverse converter's trees have exactly Flax's variable paths and shapes."""
    shapes = jax.eval_shape(lambda: step["jmodel"].init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        step["jbatch"], False))
    ref = {jax.tree_util.keystr(p): s.shape for p, s in
           jax.tree_util.tree_flatten_with_path(dict(shapes))[0]}
    got = {jax.tree_util.keystr(p): s.shape for p, s in
           jax.tree_util.tree_flatten_with_path(step["variables"])[0]}
    assert got == ref


def test_dropout_masks_recorded(step):
    """Flax draws 5 masks per cross module; the port consumed all 10, in the same shapes."""
    assert [tuple(m.shape) for m in step["masks"]] == \
        [(2, 65, 512), (1, 1, 65, 65), (2, 65, 512), (2, 65, 2048), (2, 65, 512)] * 2


def test_loss_terms_match_jax(step):
    ref, got = step["j_loss"], step["t_loss"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)


def test_gradients_match_jax(step):
    ref = _as_sd(step["j_grads"], step["variables"])
    got = step["t_grads"]
    assert set(got) == {k for k, _ in step["model"].named_parameters()}
    group_of = lambda k: k.split(".")[0]
    scale = {}
    for k in got:
        scale[group_of(k)] = max(scale.get(group_of(k), 0.0), float(np.linalg.norm(ref[k])))
    worst = {}
    for k, g in got.items():
        grp = group_of(k)
        rtol = 1e-3 if grp in HEADS else 1e-2 if grp in DENOISERS else 0.15
        r = ref[k].numpy()
        err = float(np.linalg.norm(g.numpy() - r))
        assert err <= rtol * float(np.linalg.norm(r)) + 1e-4 * scale[grp], (k, err)
        worst[grp] = max(worst.get(grp, 0.0), err / max(float(np.linalg.norm(r)), 1e-30))
    assert all(np.isfinite(v) for v in worst.values())


def test_cross_modules_take_the_other_branch_without_gradient(step):
    """Each cross module learns from its own encoder only (JAX's stop_gradient): the hand
    cross module's output has no gradient into the object encoder, and the object one's none
    into the hand encoder."""
    model = copy.deepcopy(step["model"]).train()
    out = model.trunk(step["tbatch"], DropoutMasks(masks=step["masks"]))
    for head_out, other in ((out["pd_phy"]["scale"], model.encoder_obj),
                            (out["pd_phy"]["CoM"], model.encoder_hand)):
        grads = torch.autograd.grad(head_out.sum(), list(other.parameters()), allow_unused=True)
        assert all(g is None for g in grads)


def test_batch_stats_after_step_match_jax(step):
    ref = state_dict_from_jax({"params": step["variables"]["params"],
                               "batch_stats": jax.tree.map(np.asarray, step["j_stats"]),
                               "buffers": step["variables"]["buffers"]})
    got = step["model"].state_dict()
    keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in step["model"].modules())
    for k in keys:
        r = ref[k].numpy()
        assert np.abs(got[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k
        assert not np.array_equal(got[k].numpy(), step["init_sd"][k].numpy()), k


@pytest.mark.parametrize("kw", [dict(optimizer="adamw"),
                                dict(optimizer="adam", gradient_clip=1e3)],
                         ids=["adamw", "adam_clip"])
def test_train_step_matches_jax(step, tmp_path, monkeypatch, kw):
    """``Trainer.train_step`` (forward, backward, optimizer) on the same weights, draws and
    masks: its losses, the step and update counts and the BN statistics as JAX's; then the
    port's optimizer on JAX's own gradients gives JAX's updates for every parameter within
    rtol 1e-5 (the updates of the step itself rest on gradients that differ as
    ``test_gradients_match_jax`` allows)."""
    jcfg, tcfg = (JaxConfig(**CFG, **kw), Config(**CFG, **kw, output_dir=str(tmp_path)))
    tx, _ = JT.make_optimizer(jcfg, 8)
    # optax's chain is elementwise but for the clip's global norm, so it runs here on the
    # tree flattened to one vector (one small compile instead of one over ~700 leaves)
    leaves, treedef = jax.tree.flatten(step["j_grads"])
    flat = lambda tree: jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(tree)])
    flat_up = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(
        flat(step["j_grads"]), flat(step["variables"]["params"]))
    cuts = np.cumsum([x.size for x in leaves])[:-1]
    ref_updates = jax.tree.unflatten(treedef, [
        u.reshape(x.shape) for u, x in zip(np.split(np.asarray(flat_up), cuts), leaves)])
    if kw.get("gradient_clip"):   # the clip must bind: the global norm is far above it
        assert float(jnp.linalg.norm(flat(step["j_grads"]))) > 10 * kw["gradient_clip"]

    monkeypatch.setattr(TV, "make_context", lambda *a, **k: step["tctx"])
    trainer = TT.Trainer(tcfg, device="cpu")
    trainer.model = copy.deepcopy(step["model"])
    trainer.model.load_state_dict(step["init_sd"])
    trainer.optimizer = TT.make_optimizer(tcfg, dict(trainer.model.named_parameters()), 8)
    losses = trainer.train_step(step["tbatch"], draws=step["draws"],
                                dropout=DropoutMasks(masks=step["masks"]))
    assert trainer.step == 1 and trainer.optimizer.count == 1
    for k, v in step["j_loss"].items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, step["model"].state_dict()[k]) or "running" not in k, k
    for k, p in trainer.model.named_parameters():     # every parameter with a gradient moved
        assert torch.equal(p, step["init_sd"][k]) == (not step["t_grads"][k].any()), k
    timing = trainer.train_timing()
    assert all(len(v) == 1 and v[0] > 0 for v in timing.values())

    opt = TT.make_optimizer(tcfg, {k: v.clone() for k, v in step["init_sd"].items()
                                   if k in dict(trainer.model.named_parameters())}, 8)
    j_sd = _as_sd(step["j_grads"], step["variables"])
    got = dict(zip(opt.names, opt.updates([j_sd[n] for n in opt.names])))
    ref = _as_sd(ref_updates, step["variables"])
    for n, u in got.items():
        np.testing.assert_allclose(u.numpy(), ref[n].numpy(), rtol=1e-5,
                                   atol=1e-3 * np.abs(ref[n].numpy()).max(), err_msg=n)


def test_final_model_applies_in_jax(step, tmp_path):
    """``final_model.pkl`` written by the port (after the step: trained BN statistics), read by
    the JAX package's ``--pretrain`` (``load_pretrain`` into zeroed variables, every leaf
    imported, none left over): its FPN outputs are the port's (rtol 1e-3), as are the
    encodings (rtol 1e-4)."""
    model = step["model"]
    path = str(tmp_path / "final_model.pkl")
    save_final_model(model, path)
    zeros = jax.tree.map(np.zeros_like, step["variables"])
    variables, report = load_pretrain(zeros, path)
    assert not report["missing"] and not report["unconsumed"]
    assert len(report["imported"]) == len(jax.tree.leaves(zeros))
    variables = jax.tree.map(jnp.asarray, variables)
    jout = jax.jit(lambda v, b: step["jmodel"].apply(v, b, False, method=JV.VPHONet.trunk))(
        variables, step["jbatch"])
    jfpn = jax.jit(lambda v, x: step["jmodel"].apply(
        v, x, False, method=lambda m, x, t: m.feature_extractor(x, train=t)))(
        variables, step["jbatch"]["rgb"])
    with torch.no_grad():
        tout = model.trunk(step["tbatch"])
        tfpn = model.feature_extractor(step["tbatch"]["rgb"].permute(0, 3, 1, 2))
    for j, t in zip(jfpn, tfpn):
        j = np.transpose(np.asarray(j), (0, 3, 1, 2))
        assert np.abs(t.numpy() - j).max() <= 1e-3 * np.abs(j).max()
    for k in ("encoding_hand", "encoding_obj"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(jout[k])).max(), err_msg=k)
