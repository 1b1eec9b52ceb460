"""The port's two kernels (K1 bank-MLP, K2 nearest-vertex search) against the JAX package's
Pallas kernels, plus the port's import and device rules.

On the CPU each port wrapper takes its kernel's plain version; here that plain version is
held against the Pallas kernel run in interpret mode, on the inputs of the JAX package's own
kernel tests.  The hand-written kernels themselves are tested on the card by
``tests/test_torch_port_cuda.py``.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.ops.pallas_bank import fused_bank_mlp
from vpho_tpu.ops.pallas_dist import min_dist_and_idx as jax_min_dist
from vpho_tpu_torch.ops import bank_mlp as K1
from vpho_tpu_torch.ops import min_dist as K2
from test_torch_port_cuda import _bank_case, _dist_case, _port_bank, assert_argmin_equivalent

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
        "        'vpho_tpu_torch.engine.force_optim'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vpho_tpu'))\n"
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
                assert not any(m.split(".")[0] in ("jax", "flax", "vpho_tpu") for m in mods), \
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
