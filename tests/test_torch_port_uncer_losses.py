"""PyTorch port vs the JAX package: the uncertainty losses.

URPE (``compute_rpe_uncertainty_loss``), ``uepe3d`` and UEPE3D
(``compute_rt_epe_uncertainty_loss``) with their gradients;
``compute_loss`` with all four losses; and the train CLI with ``--loss
UEPE3D|URPE --no_val``, which turns on ``uncer_prop``.

Inputs: seeded numpy arrays (B=2), and ``synthetic_batch``'s smooth scenes
at 32x40 for ``compute_loss``.  Tolerances: the losses within 1e-5
relative in float32 (UEPE3D 1e-9 in float64), their gradients within 1e-9
of the largest entry in float64.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch import losses as tl
from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data import tum as ptum
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_torch.utils import logger as plogger
from deep_prob_feature_track_tpu import losses as jlosses
from deep_prob_feature_track_tpu.geometry import lie as jl

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
B, H, W = 2, 32, 40


def _rotations(rng, n, scale):
    return np.asarray(jl.exp_so3(jnp.asarray(rng.randn(n, 3) * scale)))


def _loss_inputs(rng, dtype):
    L = 5
    R_gt = _rotations(rng, B, 0.1)
    t_gt = rng.randn(B, 3) * 0.05
    R = _rotations(rng, B * L, 0.1).reshape(B, L, 3, 3)
    t = (rng.randn(B, L, 3) * 0.05)
    A = rng.randn(B, L, 6, 6)
    info = A @ np.swapaxes(A, -1, -2) * 50.0 + np.eye(6)
    return [np.asarray(a, dtype) for a in (R, t, R_gt, t_gt, info)]


def test_rpe_uncertainty_loss_matches_jax(rng):
    args = _loss_inputs(rng, np.float32)
    got = tl.compute_rpe_uncertainty_loss(*map(torch.from_numpy, args))
    ref = jax.jit(jlosses.compute_rpe_uncertainty_loss)(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    # gradients in float64, as the loss is differentiated in training
    args = _loss_inputs(rng, np.float64)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    tl.compute_rpe_uncertainty_loss(*ts).backward()
    grads = jax.jit(jax.grad(jlosses.compute_rpe_uncertainty_loss, argnums=(0, 1, 4)))(
        *map(jnp.asarray, args))
    for g, r in zip((ts[0].grad, ts[1].grad, ts[4].grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9 * np.abs(r).max())
    assert ts[2].grad is None or not ts[2].grad.abs().any()  # the truth is detached


def test_uepe3d_matches_jax(rng):
    flow_est, flow_gt = rng.randn(2, B, 3, 6, 7).astype(np.float32)
    flow_gt[0, :, 0, 0] = np.nan
    J = rng.randn(B, 42, 3, 3)
    var = (J @ np.swapaxes(J, -1, -2) * 0.01).astype(np.float32)
    var[1, 3] = 0.0  # under the 1e-3 clamp
    invalid = (rng.rand(B, 1, 6, 7) > 0.8).astype(np.float32)
    for inv in (None, invalid):
        got = tl.uepe3d(*map(torch.from_numpy, (flow_est, flow_gt, var)),
                        invalid=None if inv is None else torch.from_numpy(inv))
        ref = jlosses.uepe3d(*map(jnp.asarray, (flow_est, flow_gt, var)),
                             invalid=None if inv is None else jnp.asarray(inv))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_rt_epe_uncertainty_loss_matches_jax(rng):
    R, t, R_gt, t_gt, info = _loss_inputs(rng, np.float64)
    sigma = np.linalg.inv(info + np.eye(6) * 1e-3) * 0.01
    depth0 = rng.uniform(0.5, 3.0, (B, 1, H, W))
    K = np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1))
    invalid = depth0 > 2.8
    args = (R, t, R_gt, t_gt, depth0, K, sigma)
    got = tl.compute_rt_epe_uncertainty_loss(*map(torch.from_numpy, args),
                                             invalid=torch.from_numpy(invalid))
    ref = jax.jit(jlosses.compute_rt_epe_uncertainty_loss)(*map(jnp.asarray, args),
                                                           invalid=jnp.asarray(invalid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12)
    ts = [torch.from_numpy(a).requires_grad_() for a in (R, t, sigma)]
    tl.compute_rt_epe_uncertainty_loss(ts[0], ts[1], *map(torch.from_numpy, args[2:6]), ts[2],
                                       invalid=torch.from_numpy(invalid))[0].sum().backward()
    grads = jax.jit(jax.grad(lambda a, b, c: jlosses.compute_rt_epe_uncertainty_loss(
        a, b, *map(jnp.asarray, args[2:6]), c, invalid=jnp.asarray(invalid))[0].sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (R, t, sigma)))
    for g, r in zip((x.grad for x in ts), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9 * np.abs(r).max())


def test_compute_loss_takes_all_four_losses():
    batch = tt.synthetic_batch(B, H, W, seed=3, device="cpu")
    net = LeastSquareTracking(apply_overrides(get_preset("feature"), ["uncer_prop=1"]))
    net.reset_parameters(7).train()
    values = {}
    for loss in ("EPE3D", "RPE", "URPE", "UEPE3D"):
        values[loss] = tt.compute_loss(net, tt.TrainConfig(loss=loss), batch)
        assert values[loss].ndim == 0 and torch.isfinite(values[loss])
    assert len({round(v.item(), 6) for v in values.values()}) == 4
    plain = LeastSquareTracking(get_preset("feature")).reset_parameters(7).train()
    for loss in ("URPE", "UEPE3D"):
        with pytest.raises(ValueError, match="uncer_prop"):
            tt.compute_loss(plain, tt.TrainConfig(loss=loss), batch)
    with pytest.raises(ValueError, match="unknown loss"):
        tt.compute_loss(net, tt.TrainConfig(loss="EPE2D"), batch)


def _save_pil(path, array):
    if array.dtype == np.uint16:
        Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path)
    else:
        Image.fromarray(array).save(path)


@pytest.mark.parametrize("loss", ["UEPE3D", "URPE"])
def test_train_cli_with_an_uncertainty_loss(tmp_path, monkeypatch, capsys, loss):
    """``--loss UEPE3D|URPE --no_val`` turns on ``uncer_prop`` and trains."""
    write_tum_sequence(str(tmp_path / "seq"), n=6, save=_save_pil)
    monkeypatch.setattr(ptum, "TUM_TRAINVAL", {"fx": ["seq"]})
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)
    built = []
    init = LeastSquareTracking.__init__

    def recording(self, cfg, *a, **kw):
        built.append(cfg)
        init(self, cfg, *a, **kw)

    monkeypatch.setattr(LeastSquareTracking, "__init__", recording)
    assert ptr.main(["--data_root", str(tmp_path), "--keyframes", "1", "--batch_size", "2",
                     "--image_resize", "0.1", "--checkpoint_folder", str(tmp_path / "logs"),
                     "--device", "cpu", "--loss", loss, "--epochs", "1",
                     "--max_steps_per_epoch", "2", "--no_val"]) == 0
    assert [c.uncer_prop for c in built] == [True]
    assert "epoch 0: loss=" in capsys.readouterr().out
    (logdir,) = (tmp_path / "logs").iterdir()
    values = [json.loads(x)["value"] for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert values and np.isfinite(values).all()
