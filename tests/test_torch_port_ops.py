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
    # every convention is ported (tests/test_torch_port_lie.py)
    close(tl.euler_to_matrix(*torch.from_numpy(a[:, :3]).T, axes="rzyx"),
          jl.euler_to_matrix(*jnp.asarray(a[:, :3]).T, axes="rzyx"))


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


def test_solve_chol_is_nan_where_not_positive_definite(rng):
    """A system that is not positive definite solves to NaN, as the JAX
    package's (and the card's) Cholesky gives; the others are unchanged."""
    J = f32(rng, 2, 50, 6)
    H = np.einsum("bpi,bpj->bij", J, J).astype(np.float32)
    H[1, 0, 1] = H[1, 1, 0] = 2.0 * np.sqrt(H[1, 0, 0] * H[1, 1, 1])  # indefinite
    rhs = f32(rng, 2, 6)
    x = ts.solve_chol(*(torch.from_numpy(a) for a in (H, rhs))).numpy()
    xj = np.asarray(js.solve_chol(jnp.asarray(H), jnp.asarray(rhs)))
    assert np.isnan(x[1]).all() and np.isnan(xj[1]).all()
    np.testing.assert_allclose(x[0], xj[0], rtol=1e-4, atol=ATOL)


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


# what the card's machine lacks: the JAX package and its host libraries
BLOCKED = ("jax", "flax", "deep_prob_feature_track_tpu", "cv2", "PIL", "pandas", "yaml",
           "tensorboard", "torch.utils.tensorboard", "matplotlib")
NEW_MODULES = ("data.association", "data.io", "data.loader", "data.pipeline", "data.png",
               "data.transforms", "data.tum", "data.tum_dicts", "evaluation",
               "training.checkpoints", "utils.logger", "utils.timers", "apps.evaluate",
               "apps.train", "apps.baselines", "apps.kf_vo", "apps.traj_eval",
               "apps.import_checkpoint", "apps.convergence_basin", "data.moving_objects",
               "utils.display", "apps.warping_objects", "parallel.ba", "parallel.dense_ba",
               "apps.ba_refine", "data.simple", "apps.run_example", "data.vary_lighting",
               "parallel.mesh", "data.jpeg", "data.scannet", "utils.debug")


def _blocked_python(code):
    """Run ``code`` in a child with ``BLOCKED`` unimportable, on one thread
    (torch and numpy's BLAS read ``OMP_NUM_THREADS`` at their import)."""
    prelude = (f"import sys\nfor m in {BLOCKED!r}:\n    sys.modules[m] = None\n")
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=240)


def test_port_imports_without_jax():
    """Every port module imports with jax, flax, the JAX package and the
    host libraries the card's machine lacks (OpenCV, PIL, pandas, PyYAML,
    TensorBoard) or may lack (matplotlib, which only the convergence
    basin's plots import) blocked, and no port file names the JAX
    package."""
    code = (
        "import pkgutil, importlib\n"
        "import deep_prob_feature_track_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n"
    )
    out = _blocked_python(code)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 35 and "deep_prob_feature_track_torch.solvers.icp" in names
    for name in NEW_MODULES:
        assert f"deep_prob_feature_track_torch.{name}" in names, name
    pkg = os.path.join(REPO, "deep_prob_feature_track_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                text = open(os.path.join(root, name)).read()
                for word in ("import jax", "from jax", "import flax", "from flax",
                             "deep_prob_feature_track_tpu import",
                             "from deep_prob_feature_track_tpu"):
                    assert word not in text, (name, word)


def test_clis_run_on_numpy_alone(tmp_path):
    """The evaluate (with a learned tracker and a baseline), train,
    keyframe VO, trajectory evaluation, checkpoint import and
    convergence-basin CLIs read a TUM-format sequence (written by
    ``chip_smoke.write_png``, no PIL) and run on the CPU with the same
    modules blocked; so do the evaluate CLI with ``--obj_only`` and
    ``--save_img`` (its PNG files through the port's writer), the train CLI
    and ``warping_objects`` (both modes) on a MovingObjects3D dataset of
    ``chip_smoke.write_mo3d_dataset``; and ``ba_refine`` with ``--dense``,
    ``run_example`` and the evaluate CLI on a VaryLighting scene."""
    code = f"""
import os
sys.path.insert(0, {REPO!r})
import chip_smoke
from deep_prob_feature_track_torch.apps import evaluate, train
from deep_prob_feature_track_torch.data import tum
root = {str(tmp_path)!r}
chip_smoke.write_tum_sequence(os.path.join(root, "seq"), n=5)
assert evaluate.main(["--data_root", "", "--trajectory", os.path.join(root, "seq"),
                      "--keyframes", "1", "--batch_size", "2", "--image_resize", "0.1",
                      "--output_dir", os.path.join(root, "out"), "--device", "cpu"]) == 0
tum.TUM_TRAINVAL.clear()
tum.TUM_TRAINVAL["fx"] = ["seq"]
assert train.main(["--data_root", root, "--keyframes", "1", "--batch_size", "2",
                   "--image_resize", "0.1", "--epochs", "1", "--max_steps_per_epoch", "1",
                   "--no_val", "--checkpoint_folder", os.path.join(root, "logs"),
                   "--device", "cpu"]) == 0
import torch
from deep_prob_feature_track_torch.apps import (convergence_basin, import_checkpoint, kf_vo,
                                                traj_eval)
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
seq = os.path.join(root, "seq")
assert evaluate.main(["--data_root", "", "--trajectory", seq, "--keyframes", "1",
                      "--batch_size", "2", "--image_resize", "0.1", "--tracker", "RGBD",
                      "--output_dir", os.path.join(root, "out"), "--device", "cpu"]) == 0
vo = os.path.join(root, "vo.txt")
assert kf_vo.main(["--data_root", "", "--trajectory", seq, "--image_resize", "0.1",
                   "--vo_type", "keyframe", "--output", vo, "--device", "cpu"]) == 0
assert traj_eval.main(["--est", vo, "--gt", os.path.join(seq, "groundtruth.txt"),
                       "--max_dt", "100"]) == 0
net = LeastSquareTracking(get_preset("feature")).reset_parameters(1)
torch.save({{"state_dict": {{"module." + k: v for k, v in net.state_dict().items()}}}},
           os.path.join(root, "ref.pth.tar"))
assert import_checkpoint.main(["--torch_checkpoint", os.path.join(root, "ref.pth.tar"),
                               "--output", os.path.join(root, "imported.pt"), "--strict"]) == 0
assert convergence_basin.main(["--data_root", "", "--trajectory", seq, "--image_resize", "0.1",
                               "--cb_dimension", "1D", "--pert_samples", "3",
                               "--checkpoint", os.path.join(root, "imported.pt"),
                               "--output", os.path.join(root, "cb.pkl"), "--device", "cpu"]) == 0
from deep_prob_feature_track_torch.apps import warping_objects
from deep_prob_feature_track_torch.data import moving_objects
moving_objects.CATEGORIES.update({{"train": {{"aeroplane": (0, 1)}}, "validation": {{}},
                                  "test": {{"boat": (0, 1), "motorbike": (0, 1)}}}})
mo3d = os.path.join(root, "mo3d")
chip_smoke.write_mo3d_dataset(mo3d, 128, 160, categories={{"aeroplane": 1, "boat": 1,
                                                           "motorbike": 1}})
assert evaluate.main(["--dataset", "MovingObjects3D", "--data_root", mo3d, "--keyframes", "1",
                      "--batch_size", "2", "--obj_only", "--save_img", "1",
                      "--output_dir", os.path.join(root, "mo3d_out"), "--device", "cpu"]) == 0
assert train.main(["--dataset", "MovingObjects3D", "--data_root", mo3d, "--keyframes", "1",
                   "--batch_size", "2", "--epochs", "1", "--max_steps_per_epoch", "1",
                   "--no_val", "--checkpoint_folder", os.path.join(root, "mo3d_logs"),
                   "--device", "cpu"]) == 0
for extra in (["--gt_pose"], []):
    assert warping_objects.main(["--data_root", mo3d, "--num_pairs", "1", "--device", "cpu",
                                 "--output_dir", os.path.join(root, "warp", *extra), *extra]) == 0
from deep_prob_feature_track_torch.apps import ba_refine, run_example
assert ba_refine.main(["--data_root", "", "--trajectory", seq, "--image_resize", "0.1",
                       "--window", "2", "--dense", "--dense_iterations", "1",
                       "--output", os.path.join(root, "ba.txt"), "--device", "cpu"]) == 0
assert run_example.main(["--color_dir", os.path.join(seq, "rgb"), "--depth_dir",
                         os.path.join(seq, "depth"), "--device", "cpu"]) == 0
os.makedirs(os.path.join(root, "vl"))
os.symlink(seq, os.path.join(root, "vl", "scene0"))
assert evaluate.main(["--dataset", "VaryLighting", "--data_root", os.path.join(root, "vl"),
                      "--trajectory", "scene0", "--keyframes", "1", "--batch_size", "2",
                      "--image_resize", "0.1", "--output_dir", os.path.join(root, "vl_out"),
                      "--device", "cpu"]) == 0
"""
    out = _blocked_python(code)
    assert out.returncode == 0, out.stderr
    assert os.path.isfile(tmp_path / "out" / "nolearning_feature" / "summary.csv")
    assert os.path.isfile(tmp_path / "out" / "nolearning_RGBD" / "summary.csv")
    assert len((tmp_path / "vo.txt").read_text().splitlines()) == 5
    assert '"ate_rmse_m"' in out.stdout
    assert os.path.isfile(tmp_path / "imported.pt") and os.path.isfile(tmp_path / "cb.pkl")
    assert len(list((tmp_path / "logs").rglob("checkpoint_epoch1.pt"))) == 1
    mo3d_out = tmp_path / "mo3d_out" / "nolearning_feature"
    assert os.path.isfile(mo3d_out / "summary.csv")
    assert len(list((mo3d_out / "vis").rglob("*.png"))) == 13
    assert len(list((tmp_path / "mo3d_logs").rglob("checkpoint_epoch1.pt"))) == 1
    assert {p.name for p in (tmp_path / "warp").rglob("*.png")} == {"pair_0000.png"}
    assert len(list((tmp_path / "warp").rglob("*.png"))) == 2
    assert len((tmp_path / "ba.txt").read_text().splitlines()) == 5
    assert out.stdout.count("translation:") == 4 and "4 poses estimated" in out.stdout
    assert os.path.isfile(tmp_path / "vl_out" / "nolearning_feature" / "summary.csv")


def test_mesh_and_scannet_clis_run_on_numpy_alone(tmp_path):
    """With the same modules blocked, on a mesh of this process alone
    (gloo): the train CLI with ``--accum_steps 2 --mesh --debug_nan``, the
    evaluate CLI with ``--mesh`` and ``ba_refine --sharded`` on a written
    TUM-format sequence, and both CLIs on a ScanNet scan of
    ``chip_smoke.write_scannet_scan`` (JPEG colour, no OpenCV)."""
    code = f"""
import os
sys.path.insert(0, {REPO!r})
import chip_smoke
from deep_prob_feature_track_torch.apps import ba_refine, evaluate, train
from deep_prob_feature_track_torch.data import tum
root = {str(tmp_path)!r}
seq = os.path.join(root, "seq")
chip_smoke.write_tum_sequence(seq, n=5)
tum.TUM_TRAINVAL.clear()
tum.TUM_TRAINVAL["fx"] = ["seq"]
assert train.main(["--data_root", root, "--keyframes", "1", "--batch_size", "2",
                   "--image_resize", "0.1", "--epochs", "1", "--max_steps_per_epoch", "1",
                   "--no_val", "--checkpoint_folder", os.path.join(root, "mesh_logs"),
                   "--accum_steps", "2", "--mesh", "--debug_nan", "--device", "cpu"]) == 0
assert evaluate.main(["--data_root", "", "--trajectory", seq, "--keyframes", "1", "--mesh",
                      "--batch_size", "2", "--image_resize", "0.1",
                      "--output_dir", os.path.join(root, "mesh_out"), "--device", "cpu"]) == 0
assert ba_refine.main(["--data_root", "", "--trajectory", seq, "--image_resize", "0.1",
                       "--window", "2", "--sharded", "--output", os.path.join(root, "bas.txt"),
                       "--device", "cpu"]) == 0
scannet = os.path.join(root, "scannet")
chip_smoke.write_scannet_scan(os.path.join(scannet, "val", "scene0011_00"), n=4)
chip_smoke.write_scannet_scan(os.path.join(scannet, "train", "scene0000_00"), n=4)
assert evaluate.main(["--dataset", "ScanNet", "--data_root", scannet, "--trajectory",
                      "scene0011_00", "--keyframes", "1", "--batch_size", "2",
                      "--image_resize", "0.1", "--output_dir", os.path.join(root, "sn_out"),
                      "--device", "cpu"]) == 0
assert train.main(["--dataset", "ScanNet", "--data_root", scannet, "--keyframes", "1",
                   "--batch_size", "2", "--image_resize", "0.1", "--epochs", "1",
                   "--max_steps_per_epoch", "1", "--no_val", "--checkpoint_folder",
                   os.path.join(root, "sn_logs"), "--device", "cpu"]) == 0
"""
    out = _blocked_python(code)
    assert out.returncode == 0, out.stderr
    for logs in ("mesh_logs", "sn_logs"):
        assert len(list((tmp_path / logs).rglob("checkpoint_epoch1.pt"))) == 1, logs
    assert os.path.isfile(tmp_path / "mesh_out" / "nolearning_feature" / "summary.csv")
    assert os.path.isfile(tmp_path / "sn_out" / "nolearning_feature" / "summary.csv")
    assert len((tmp_path / "bas.txt").read_text().splitlines()) == 5
