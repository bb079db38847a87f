"""PyTorch port vs the JAX package: lie, image and 6x6 solver ops.

Inputs are numpy arrays from a seed, fed to both; JAX arrays are built as
float32 explicitly (conftest enables x64).  Tolerance: atol 1e-6 at f32
unless stated.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch import resolve_device
from deep_prob_feature_track_torch.geometry import lie as tl
from deep_prob_feature_track_torch.ops import image as ti
from deep_prob_feature_track_torch.ops import kernels as tk
from deep_prob_feature_track_torch.ops import solver6 as ts
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.ops import image as ji
from deep_prob_feature_track_tpu.ops import solver6 as js

torch.set_num_threads(2)
ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_skew_and_exp_so3(rng):
    w = f32(rng, 5, 3, scale=0.3)
    w[0] = 0.0  # the small-angle branch
    w[1] = 1e-5
    close(tl.skew(torch.from_numpy(w)), jl.skew(jnp.asarray(w)))
    close(tl.exp_so3(torch.from_numpy(w)), jl.exp_so3(jnp.asarray(w)))


def test_compose(rng):
    R0 = np.array(jl.exp_so3(jnp.asarray(f32(rng, 4, 3, scale=0.5))))
    dR = np.array(jl.exp_so3(jnp.asarray(f32(rng, 4, 3, scale=0.5))))
    t0, dt = f32(rng, 4, 3), f32(rng, 4, 3)
    got = tl.compose(*map(torch.from_numpy, (dR, dt, R0, t0)))
    ref = jl.compose(*map(jnp.asarray, (dR, dt, R0, t0)))
    for a, b in zip(got, ref):
        close(a, b)


def test_euler_and_pose_vec(rng):
    a = f32(rng, 3, 6, scale=0.4)
    close(tl.euler_to_matrix(*torch.from_numpy(a[:, :3]).T),
          jl.euler_to_matrix(*jnp.asarray(a[:, :3]).T))
    R, t = tl.pose_vec_to_Rt(torch.from_numpy(a))
    Rj, tj = jl.pose_vec_to_Rt(jnp.asarray(a))
    close(R, Rj)
    close(t, tj)
    with pytest.raises(NotImplementedError):
        tl.euler_to_matrix(*torch.from_numpy(a[:, :3]).T, axes="rzyx")


@pytest.mark.parametrize("normalize", [True, False])
def test_sobel_gradients(rng, normalize):
    img = f32(rng, 2, 3, 12, 17)
    gx, gy = ti.sobel_gradients(torch.from_numpy(img), normalize)
    jx, jy = ji.sobel_gradients(jnp.asarray(img), normalize)
    # unnormalized |g| reaches ~16, so the convs' last-bit differences reach
    # ~2e-6; normalizing divides them by |g|, which is small at a few pixels
    # (measured 4.3e-5 relative), hence rtol 1e-4 there
    tol = dict(atol=ATOL, rtol=1e-4) if normalize else dict(atol=1e-5)
    close(gx, jx, **tol)
    close(gy, jy, **tol)


@pytest.mark.parametrize("pool", ["avg", "max"])
def test_image_pyramid(rng, pool):
    x = f32(rng, 2, 1, 32, 40)
    got = ti.image_pyramid(torch.from_numpy(x), pool=pool)
    ref = ji.image_pyramid(jnp.asarray(x), pool=pool)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        close(g, r)


def test_lev_mar_damp_and_solve_chol(rng):
    J = f32(rng, 3, 50, 6)
    JtJ = np.einsum("bpi,bpj->bij", J, J).astype(np.float32)
    JtJ[2] = 0.0  # textureless frame: the absolute floor keeps it finite
    rhs = f32(rng, 3, 6)
    H = ts.lev_mar_damp(torch.from_numpy(JtJ))
    Hj = js.lev_mar_damp(jnp.asarray(JtJ))
    close(H, Hj, atol=1e-5)  # |H| ~ 50
    x = ts.solve_chol(H, torch.from_numpy(rhs))
    xj = js.solve_chol(Hj, jnp.asarray(rhs))
    np.testing.assert_allclose(x[:2].numpy(), np.asarray(xj)[:2], rtol=1e-4, atol=ATOL)
    assert torch.isfinite(x).all()
    x3 = ts.solve_chol(H, torch.from_numpy(rhs)[..., None])
    assert x3.shape == (3, 6, 1)
    torch.testing.assert_close(x3[..., 0], x, rtol=0, atol=0)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _gather_args():
    F = torch.zeros(1, 4, 5, 2)
    i = torch.zeros(1, 3, dtype=torch.int32)
    f = torch.zeros(1, 3)
    return F, i, f, i, f


def _jtj_args():
    a = torch.zeros(1, 2, 7)
    u = torch.zeros(1, 7, 6)
    return a, a, a, u, u


@pytest.mark.parametrize("entry,args", [
    (tk.gather_twohot_cuda, _gather_args),
    (tk.fused_jtj_jtr_cuda, _jtj_args),
])
def test_cuda_entries_refuse_cpu_tensors(entry, args):
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        entry(*args())
    assert tk.LAUNCHES == before


def test_port_imports_without_jax():
    """Every port module imports with jax, flax and the JAX package blocked,
    and no port file names them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'deep_prob_feature_track_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import deep_prob_feature_track_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 21 and "deep_prob_feature_track_torch.solvers.icp" in names
    pkg = os.path.join(REPO, "deep_prob_feature_track_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                text = open(os.path.join(root, name)).read()
                for word in ("import jax", "from jax", "import flax", "from flax",
                             "deep_prob_feature_track_tpu import",
                             "from deep_prob_feature_track_tpu"):
                    assert word not in text, (name, word)
