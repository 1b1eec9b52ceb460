"""The train step as CUDA graphs (``engine/trainer.py::make_train_step``) and the host-free
``rigid_align`` of the jitted metrics, on the CPU, against the JAX package and against the
eager forms they replaced:

  * the ``Optimizer`` driven as the graphs drive it (``advance`` on the host, then
    ``accumulate`` and ``apply`` reading the device scalars) against optax's chain
    (``make_optimizer``: ``clip_by_global_norm``, ``MultiSteps(2)``, the ``exp`` schedule at one
    step an epoch) over 6 calls, the clip binding on some updates and not on others, at
    ``tests/test_torch_port_optim.py``'s bars; and bit for bit equal to the parent commit's
    float-driven ``Optimizer`` (copied below); a NaN gradient takes the clip's divide branch;
  * ``rigid_align`` (Horn's quaternion form, no SVD) against ``jax.vmap(rigid_align)`` at atol
    1e-6 on random sets, reflections, coplanar and collinear sets, and (hypothesis) sets near
    a reflection and near a plane;
  * ``TrainStep`` with a stand-in for the CUDA graph: every replay's operations must take the
    same non-tensor arguments as the capture's (a real graph bakes those in), and 4 replayed
    calls equal 4 eager ``Trainer.train_step`` calls bit for bit (losses, parameters, Adam
    moments, the accumulator, BN statistics), with the clip binding, accumulation over 2 calls
    and a learning rate that changes at every update.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from vpho_tpu.configs.config import Config as JaxConfig
from vpho_tpu.engine import trainer as JT
from vpho_tpu.utils import transforms as JTR
from vpho_tpu_torch.configs.config import Config, get_config
from vpho_tpu_torch.data import fixtures as tfix
from vpho_tpu_torch.engine import graphs as G
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.utils import transforms as TTR

torch.set_num_threads(1)

_F32 = np.float32


class ParentOptimizer:
    """The parent commit's ``engine/trainer.py::Optimizer`` (bias corrections, learning rate and
    accumulation divisor as host floats, the clip norm read with ``.item()``), the reference the
    device-scalar form must equal bit for bit."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, kind, schedule, clip=-1.0, every=1):
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        self.kind, self.schedule, self.clip, self.every = kind, schedule, clip, every
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if every > 1 else None
        self.count = 0
        self.mini_step = 0

    @torch.no_grad()
    def updates(self, grads):
        g = list(grads)
        if self.acc is not None:
            step = torch._foreach_sub(g, self.acc)
            torch._foreach_div_(step, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, step)
            self.mini_step += 1
            if self.mini_step < self.every:
                return None
            g, self.acc, self.mini_step = self.acc, [torch.zeros_like(a) for a in self.acc], 0
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))).item()
            if not norm < self.clip:
                g = torch._foreach_div(g, norm)
                torch._foreach_mul_(g, self.clip)
        if self.kind == "adam":
            g = torch._foreach_add(g, self.params, alpha=5e-4)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
        self.count += 1
        bc1 = float(_F32(1.0) - _F32(self.b1) ** _F32(self.count))
        bc2 = float(_F32(1.0) - _F32(self.b2) ** _F32(self.count))
        lr = self.schedule(self.count - 1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        if self.kind == "adamw":
            torch._foreach_add_(u, self.params, alpha=1e-4)
        torch._foreach_mul_(u, -lr)
        return u

    @torch.no_grad()
    def step(self, grads):
        u = self.updates(grads)
        if u is not None:
            torch._foreach_add_(self.params, u)
        return u is not None


SHAPES = {"conv": (3, 3, 4, 8), "dense": (16, 5), "bias": (5,), "bank": (2, 6, 3)}
# the clip's threshold against each cycle's mean gradient norm: binds, does not, binds
CLIP, CYCLE_NORMS = 1.0, ((4.0, 2.0), (0.2, 0.3), (1.5, 0.9))


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_device_scalar_optimizer_matches_optax_and_the_parent(kind):
    """6 calls of MultiSteps(2) with the clip: the parameters after each call within
    ``test_optimizer_matches_optax``'s bars of optax (each update rtol 1e-5 of itself, the
    parameters rtol 1e-6), the parameters unmoved between boundaries, and every parameter and
    moment equal to the parent's float-driven optimizer bit for bit."""
    kw = dict(optimizer=kind, gradient_clip=CLIP, gradient_accumulation_steps=2,
              scheduler="exp", gamma=0.5, base_learning_rate=1e-2)
    tx, _ = JT.make_optimizer(JaxConfig(**kw), 1)
    rng = np.random.RandomState(0)
    p0 = {k: (rng.randn(*s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}
    jp = jax.tree.map(jnp.asarray, p0)
    jst = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = TT.make_optimizer(Config(**kw), tp, 1)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    parent = ParentOptimizer(pp, kind, TT.make_lr_schedule(Config(**kw), 1), clip=CLIP, every=2)
    bound = []
    for cycle, norms in enumerate(CYCLE_NORMS):
        direction = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        scale = np.sqrt(sum((d ** 2).sum() for d in direction.values()))
        means = []
        for norm in norms:
            g = {k: (d / scale * norm + 0.01 * rng.randn(*d.shape)).astype(np.float32)
                 for k, d in direction.items()}
            means.append(g)
            up, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
            jp = optax.apply_updates(jp, up)
            before = {n: v.clone() for n, v in tp.items()}
            applies = opt.advance()                      # as the graphs drive it
            opt.accumulate([torch.from_numpy(g[n]) for n in opt.names])
            if applies:
                opt.apply()
            assert parent.step([torch.from_numpy(g[n]) for n in opt.names]) == applies
            for n in opt.names:
                ref = np.asarray(up[n])
                if not applies:
                    np.testing.assert_array_equal(tp[n].numpy(), before[n].numpy())
                else:
                    spacing = 2 * np.spacing(np.abs(before[n].numpy()).max())
                    np.testing.assert_allclose((tp[n] - before[n]).numpy(), ref, rtol=1e-5,
                                               atol=spacing, err_msg=f"{n} {cycle}")
                np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6,
                                           atol=1e-7)
                assert torch.equal(tp[n], pp[n]), (n, cycle)
        mean = {k: (means[0][k] + means[1][k]) / 2 for k in SHAPES}
        bound.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in mean.values())) >= CLIP)
    assert bound == [True, False, True]
    for a, b in zip(opt.mu + opt.nu + opt.acc, parent.mu + parent.nu + parent.acc):
        assert torch.equal(a, b)
    assert (opt.count, opt.mini_step) == (parent.count, parent.mini_step) == (3, 0)
    # one NaN in one gradient makes the norm NaN, and the divide branch (optax's ``where``)
    # spreads it to every parameter; the keep branch would leave the others finite
    for o in (opt, parent):
        g = [torch.zeros_like(p) for p in o.params]
        g[0].view(-1)[0] = float("nan")
        o.step(g)
        o.step([torch.zeros_like(p) for p in o.params])
    assert all(bool(torch.isnan(p).all()) for p in opt.params + parent.params)


def _align_f64(A, B):
    """The SVD form of ``rigid_align`` in float64 (numpy): the answer both float32 forms round."""
    A, B = A.astype(np.float64), B.astype(np.float64)
    a, b = A - A.mean(-2, keepdims=True), B - B.mean(-2, keepdims=True)
    U, s, Vt = np.linalg.svd(np.einsum("nki,nkj->nij", a, b) / A.shape[-2])
    d = np.sign(np.linalg.det(np.einsum("nji,nkj->nik", Vt, U)))
    s[:, 2] *= d
    Vt[:, 2] *= d[:, None]
    R = np.einsum("nji,nkj->nik", Vt, U)
    c = s.sum(-1) / A.var(-2).sum(-1)
    aligned = c[:, None, None] * np.einsum("nij,nkj->nki", R, A)
    return aligned + B.mean(-2, keepdims=True) - aligned.mean(-2, keepdims=True)


def _align_check(A, B):
    """atol 1e-6 of JAX (``test_rigid_align_and_pose_helpers``' bar).  Over 778 vertices JAX's
    own float32 SVD is ~1.1e-6 from the float64 answer (the parent's ``torch.linalg.svd`` form
    ~1.0e-6 from JAX), so there the port is held within 1e-6 of the float64 answer and no
    farther from JAX than JAX is from it, plus 1e-6."""
    got = TTR.rigid_align(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    ref = np.asarray(jax.vmap(JTR.rigid_align)(A, B))
    if A.shape[-2] <= 21:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        return
    exact = _align_f64(A, B)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    assert np.abs(got - ref).max() <= np.abs(ref - exact).max() + 1e-6


def _rotations(rng, n):
    return np.asarray(JTR.axis_angle_to_matrix(rng.randn(n, 3).astype(np.float32)))


def test_rigid_align_matches_jax():
    """Random hands (21 joints, 778 vertices) at 0.05 m, a third reflected (the SVD form's
    det < 0 branch); coplanar and collinear sets: atol 1e-6."""
    rng = np.random.RandomState(0)
    for npts in (21, 778):
        A = (rng.randn(64, npts, 3) * 0.05).astype(np.float32)
        R = _rotations(rng, 64)
        B = (1.3 * np.einsum("nij,nkj->nki", R, A) + rng.randn(64, npts, 3) * 0.004
             + [0.0, 0.0, 0.6]).astype(np.float32)
        B[::3] = -B[::3]
        _align_check(A, B)
        flat = A.copy()
        flat[..., 2] = 0.0                                 # coplanar: sigma3 = 0
        _align_check(flat, B)
        line = (A[..., :1] * np.array([1.0, 2.0, -0.5], np.float32)).astype(np.float32)
        _align_check(line, B)                              # collinear: sigma2 = sigma3 = 0


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), log_thin=st.floats(-6.0, -1.0),
       mirror=st.booleans(), noise=st.floats(0.0, 0.01))
def test_rigid_align_near_a_plane_or_a_reflection(seed, log_thin, mirror, noise):
    """A set whose third axis is 10^log_thin of the others (near coplanar), mapped by a rotation
    or by a reflection (``mirror``: the best orthogonal map is improper, so the proper rotation
    takes the flipped singular value) plus noise: atol 1e-6 of JAX."""
    rng = np.random.RandomState(seed)
    A = rng.randn(8, 21, 3) * [0.06, 0.04, 0.05 * 10.0 ** log_thin]
    A = np.einsum("nij,nkj->nki", _rotations(rng, 8), A)
    B = np.einsum("nij,nkj->nki", _rotations(rng, 8), A) * rng.uniform(0.8, 1.2, (8, 1, 1))
    if mirror:
        B[..., 0] = -B[..., 0]
    B = B + rng.randn(*B.shape) * noise + [0.0, 0.0, 0.6]
    _align_check(A.astype(np.float32), B.astype(np.float32))


# ---- the train step with a stand-in for the CUDA graph -------------------------------------


class _Baked(TorchDispatchMode):
    """Records each operation with its non-tensor arguments: what a CUDA graph bakes in."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        leaves = pytree.tree_leaves((args, kwargs or {}))
        self.ops.append((str(func), tuple(repr(x) for x in leaves
                                         if not isinstance(x, torch.Tensor))))
        return func(*args, **(kwargs or {}))


class _CheckedReplayOnCPU:
    """Stands in for ``graphs.Graph`` on the CPU.  "Capture" records ``fn``'s operations and
    their non-tensor arguments (running it on the CPU, then putting back the state it moved:
    a real capture runs nothing); every "replay" runs ``fn`` and must record the same."""

    state = []                              # the tensors a call moves, set by the test
    marks = {}                              # a CPU "capture" records no stage marks

    def __init__(self, fn, device, name, warm=True, signature="", marked=False):
        if warm:
            fn()
        saved = [t.detach().clone() for t in self.state]
        with _Baked() as baked:
            self.out = fn()
        with torch.no_grad():
            for t, s in zip(self.state, saved):
                t.copy_(s)
        self.fn, self.baked, self.replays = fn, baked.ops, 0

    def replay(self):
        with _Baked() as now:
            out = self.fn()
        assert now.ops == self.baked, next(
            (a, b) for a, b in zip(now.ops, self.baked) if a != b)
        for mine, fresh in zip(pytree.tree_leaves(self.out), pytree.tree_leaves(out)):
            if isinstance(mine, torch.Tensor):
                mine.detach().copy_(fresh)
        self.replays += 1


def _state(trainer):
    opt = trainer.optimizer
    return (opt.params + opt.mu + opt.nu + opt.acc + [opt.scalars]
            + [b for b in trainer.model.buffers()])


def test_train_step_replays_read_every_varying_number_from_inputs(monkeypatch, tmp_path):
    """bs 2, patch 64, f32; the clip binds (its threshold far under the gradients' norm),
    MultiSteps over 2 calls, ``exp`` at one step an epoch with gamma 0.5 (every update has its
    own learning rate): ``make_train_step``'s graphs (a stand-in that holds each replay to the
    capture's non-tensor arguments) over 4 calls equal 4 eager ``train_step`` calls from the
    same state and generator seed, bit for bit: losses, parameters, moments, accumulator, BN
    statistics; the masks and draws drawn before each replay are the eager step's."""
    argv = ["--mode", "train", "--batch_size", "2", "--patch_size", "64", "--repeat_num", "2",
            "--gradient_clip", "1e-3", "--gradient_accumulation_steps", "2", "--scheduler",
            "exp", "--gamma", "0.5", "--output_dir", str(tmp_path)]
    runs = []
    for captured in (True, False):
        trainer = TT.Trainer(get_config(argv), device="cpu")
        trainer.init_state(1)
        if runs:
            trainer.model.load_state_dict(runs[0][3])
        sd0 = copy.deepcopy(trainer.model.state_dict())
        batch = tfix.make_batch(trainer.ctx, seed=0, batch_size=2, patch_size=64)
        gen = torch.Generator().manual_seed(5)
        if captured:
            monkeypatch.setattr(G, "Graph", _CheckedReplayOnCPU)
            monkeypatch.setattr(G, "warm_up", lambda fn, device, name="": fn())
            monkeypatch.setattr(G.CapturedStep, "_device",
                                staticmethod(lambda leaves: torch.device("cuda")))
            monkeypatch.setattr(G, "capturable", lambda device: True)
            _CheckedReplayOnCPU.state = _state(trainer)
        losses = [trainer.train_step(batch, generator=gen) for _ in range(4)]
        if captured:
            step = trainer._step("train")
            graph = next(iter(step.graph.graphs.values()))[1]
            assert graph.replays == 3 and step.apply_graph.replays == 1
            monkeypatch.undo()
        runs.append((losses, [t.clone() for t in _state(trainer)], trainer.optimizer.count, sd0))
    (l_graph, s_graph, n_graph, _), (l_eager, s_eager, n_eager, _) = runs
    assert n_graph == n_eager == 2
    for a, b in zip(l_graph, l_eager):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k].float()) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(s_graph, s_eager))
