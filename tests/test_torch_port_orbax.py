"""``orbax_to_torch.py``: a JAX-package training checkpoint (an orbax ``epoch_N.state``
directory) resumed by the port.

The JAX ``Trainer`` (patch 64, bs 2, repeat_num 2, AdamW; the weights of
``test_torch_port_train``, carried to Flax, in its ``TrainState``) takes one step, as its jitted
``make_train_step`` does, and saves orbax with ``save_checkpoint(1)``; then it takes the next
step on another batch.  The converter writes the port's file, the port's
``Trainer`` resumes from it (``--checkpoint``) and takes that next step with JAX's draws and
dropout masks.  The restored weights, statistics and buffers are JAX's bit for bit; then,
with ``test_torch_port_train``'s bars: loss terms rtol 1e-4; BN statistics after the step
1e-3 x the largest value; the port's optimizer, restored from the file, on JAX's gradients of
that step: JAX's update within rtol 1e-5 and 1e-3 x the largest update (plus the two ulps lost
in reading JAX's update as a difference of parameters).

The gradients of the step itself are not held to the train test's per-module bars here: how
close the port's are to JAX's depends on the batch's conditioning (train-mode BN at bs 2), not
on the restored state, and at this state and batch the cross modules' gradients miss the 1e-3
head bar that the train test's own case meets.  A second case converts an optax ``MultiSteps`` state with a clip, saved the way
the JAX trainer saves, and compares every leaf exactly.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.configs.config import get_config as jax_get_config
from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import trainer as JT
from vpho_tpu.models import vpho as JV
from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.models.layers import DropoutMasks
from vpho_tpu_torch.utils.weights import jax_variables_from_state_dict
from test_torch_port_train import _as_sd, _port_model, _score_draws

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import orbax_to_torch  # noqa: E402

torch.set_num_threads(1)

ARGV = ["--repeat_num", "2", "--patch_size", "64", "--batch_size", "2", "--num_devices", "1"]


def _recording_step(model, ctx):
    """``make_train_step``'s step, also returning the loss terms, the gradients and the
    dropout masks it drew."""
    masks, bernoulli = [], jax.random.bernoulli

    def recording(key, p=0.5, shape=None, **kw):
        m = bernoulli(key, p, shape, **kw)
        masks.append(m)
        return m

    def step(state, batch, rng):
        masks.clear()
        rng = jax.random.fold_in(rng, state.step)

        def loss_fn(params):
            v = {"params": params, "batch_stats": state.batch_stats, "buffers": state.buffers}
            total, loss_dt, mutated = JV.forward_train(model, v, ctx, batch, rng)
            return total, (loss_dt, mutated)

        (_, (loss_dt, mutated)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        new = state.apply_gradients(grads=grads).replace(batch_stats=mutated["batch_stats"])
        return new, loss_dt, grads, list(masks)

    jitted = jax.jit(step)

    def run(*args):
        mp = pytest.MonkeyPatch()
        mp.setattr(jax.random, "bernoulli", recording)
        try:
            return jitted(*args)
        finally:
            mp.undo()

    return run


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    jtr = JT.Trainer(jax_get_config(ARGV + ["--output_dir", str(tmp / "jax")]))
    batches = [jax_make_batch(jtr.ctx, jax.random.PRNGKey(s), 2, 64) for s in (8, 9)]
    v = jax.tree.map(jnp.asarray, jax_variables_from_state_dict(_port_model().state_dict()))
    jtr.state = JT.TrainState.create(apply_fn=jtr.model.apply, params=v["params"],
                                     tx=JT.make_optimizer(jtr.cfg, 8)[0],
                                     batch_stats=v["batch_stats"], buffers=v["buffers"])
    step = _recording_step(jtr.model, jtr.ctx)
    rng = jax.random.PRNGKey(1000)
    state1, _, _, _ = step(jtr.state, batches[0], rng)
    jtr.state = state1
    jtr.save_checkpoint(1)
    state2, loss2, grads2, masks2 = step(state1, batches[1], rng)

    src = os.path.join(jtr.save_dir, "checkpoint", "epoch_1.state")
    dst = str(tmp / "port" / "epoch_1.state")
    orbax_to_torch.main([src, dst])
    ttr = TT.Trainer(get_config(ARGV + ["--output_dir", str(tmp / "torch"), "--checkpoint",
                                        dst]), "cpu")
    ttr.init_state(steps_per_epoch=8)
    restored = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    _, rng_hand, rng_obj = jax.random.split(jax.random.fold_in(rng, 1), 3)
    eps = jtr.ctx.sde.eps
    draws = {"hand": _score_draws(rng_hand, 4, 96, eps), "obj": _score_draws(rng_obj, 4, 9, eps)}
    losses = ttr.train_step({k: torch.from_numpy(np.array(v)) for k, v in batches[1].items()},
                            draws=draws,
                            dropout=DropoutMasks(masks=[torch.from_numpy(np.array(m))
                                                        for m in masks2]))
    variables = lambda s: {"params": s.params, "batch_stats": s.batch_stats,
                           "buffers": s.buffers}
    return dict(jtr=jtr, state1=state1, state2=state2, loss2=loss2, grads2=grads2, ttr=ttr,
                dst=dst, restored=restored, losses=losses, variables=variables)


def test_resume_restores_the_jax_state(resumed):
    """The port resumes at JAX's step and epoch, with JAX's weights and statistics."""
    ttr, state1 = resumed["ttr"], resumed["state1"]
    assert ttr.start_epoch == 1 and ttr.optimizer.count == 2 and ttr.step == 2
    ref = _as_sd(state1.params, resumed["variables"](state1))
    for k, v in ref.items():
        np.testing.assert_array_equal(resumed["restored"][k].numpy(), v.numpy(), err_msg=k)


def test_next_step_matches_jax(resumed):
    """The resumed port's next step on JAX's draws: JAX's loss terms and BN statistics within
    the train bars."""
    for k, v in resumed["loss2"].items():
        np.testing.assert_allclose(resumed["losses"][k].item(), float(v), rtol=1e-4, err_msg=k)
    state2 = resumed["state2"]
    ref = _as_sd(state2.params, resumed["variables"](state2))
    got = resumed["ttr"].model.state_dict()
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            r = ref[k].numpy()
            assert np.abs(got[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k


def test_restored_optimizer_gives_jax_update(resumed):
    """The optimizer state read from the converted file, fed JAX's gradients of the next step,
    moves the parameters as JAX's moved them."""
    state1, state2 = resumed["state1"], resumed["state2"]
    p1 = _as_sd(state1.params, resumed["variables"](state1))
    p2 = _as_sd(state2.params, resumed["variables"](state2))
    g2 = _as_sd(resumed["grads2"], resumed["variables"](state1))
    cfg = resumed["ttr"].cfg
    opt = TT.make_optimizer(cfg, {n: p1[n].clone() for n in resumed["ttr"].optimizer.names}, 8)
    opt.load_state_dict(torch.load(resumed["dst"], weights_only=True)["opt_state"])
    got = dict(zip(opt.names, opt.updates([g2[n] for n in opt.names])))
    for n, u in got.items():
        ref = (p2[n] - p1[n]).numpy()
        atol = 1e-3 * np.abs(ref).max() + 2 * np.spacing(np.abs(p2[n].numpy()).max())
        np.testing.assert_allclose(u.numpy(), ref, rtol=1e-5, atol=atol, err_msg=n)


def test_multisteps_state_converts(tmp_path):
    """``--gradient_accumulation_steps 2 --gradient_clip 1``: the optax state, with every leaf
    made non-zero and saved as the JAX trainer saves it, converts leaf for leaf."""
    import orbax.checkpoint as ocp

    from vpho_tpu_torch.models import vpho as TV

    model = TV.build_model(TV.ModelConfig(), seed=0, device="cpu")
    variables = jax_variables_from_state_dict(model.state_dict())
    cfg = jax_get_config(["--gradient_accumulation_steps", "2", "--gradient_clip", "1"])
    tx, _ = JT.make_optimizer(cfg, 8)
    rng = np.random.RandomState(0)
    fill = lambda tree: jax.tree.map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), tree)
    state = tx.init(variables["params"])
    inner = state.inner_opt_state
    adam = inner[1][0]
    adam = adam._replace(count=jnp.int32(5), mu=fill(adam.mu), nu=jax.tree.map(abs, fill(adam.nu)))
    state = state._replace(mini_step=jnp.int32(1), acc_grads=fill(state.acc_grads),
                           inner_opt_state=(inner[0], (adam,) + tuple(inner[1][1:])))
    src = str(tmp_path / "epoch_3.state")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(src, dataclasses.asdict(JT._StatePayload(
        params=variables["params"], batch_stats=variables["batch_stats"],
        buffers=variables["buffers"], opt_state=state, step=jnp.int32(11))))
    ckptr.wait_until_finished()
    out = orbax_to_torch.convert(src, str(tmp_path / "port" / "epoch_3.state"))
    opt = out["opt_state"]
    assert (opt["count"], opt["mini_step"], out["step"]) == (5, 1, 11)
    full = lambda tree: _as_sd(tree, variables)
    for key, tree in (("mu", adam.mu), ("nu", adam.nu), ("acc", state.acc_grads)):
        ref = full(tree)
        assert set(opt[key]) == {k for k, _ in model.named_parameters()}
        for k, v in opt[key].items():
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=(key, k))
    model.load_state_dict({**out["params"], **out["batch_stats"], **out["buffers"]}, strict=True)
