"""PyTorch port vs the JAX package: uncertainty propagation (ROADMAP item 4).

``uncer_prop`` on the four tracks (U_IC with its fused ICP term, IC, U_FC,
ICP): the eval forward's ``((R, t), JtWJ of level 0)`` and the training
forward's ``(pyr_R, pyr_t, sigma_ksi)``; and the validation of an
``uncer_prop`` tracker, which stops in both packages.  The losses are in
``tests/test_torch_port_uncer_losses.py``, a training step's gradients in
``tests/test_torch_port_uncer_train.py``.

Weights: the port's seeded init, carried to the JAX package by its
``convert_state_dict``.  Inputs: ``synthetic_batch``'s smooth scenes at
B=2, 32x40.
Tolerances: the four tracks in float64, 1e-8 on poses and each
information matrix within 1e-8 of its largest entry; U_IC also in float32,
1e-4 on poses and 1e-4 of the largest entry (its entries sum over the
level's pixels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch import evaluation as pe
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking, TrackerConfig
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.models.tracker import TrackerConfig as JaxConfig

torch.set_num_threads(2)
B, H, W = 2, 32, 40
POSE_ATOL = 1e-4
INFO_RTOL = 1e-4

# the four tracks with uncer_prop: U_IC with the fused ICP term from the
# predicted pose, and the JAX package's own IC, U_FC and ICP cases
# (tests/test_tracker.py::test_uncer_prop_all_tracks) from the identity
TRACKS = {
    "U_IC": ("feature_icp", {}),
    "IC": (None, dict(encoder_name="ConvRGBD2", uncertainty_type="None", direction="inverse",
                      mest_type="MultiScale2w", feature_channel=1, feature_extract="average",
                      init_pose_type="identity", train_init_pose=False,
                      remove_tru_sigma=False)),
    "U_FC": (None, dict(encoder_name="ConvRGBD2", uncertainty_type="laplacian",
                        direction="forward", feature_channel=4, init_pose_type="identity",
                        train_init_pose=False, remove_tru_sigma=False)),
    "ICP": (None, dict(encoder_name="ICP", uncertainty_type="ICP", direction="inverse",
                       init_pose_type="identity", train_init_pose=False,
                       remove_tru_sigma=False)),
}


def _inputs(seed=3):
    """``synthetic_batch``'s smooth textured scene: on uniform-noise depth
    the ICP track's float32 occlusion test flips pixels between two
    roundings (ROADMAP queue 3), and its information matrix with them."""
    batch = tt.synthetic_batch(B, H, W, seed=seed, device="cpu")
    return tuple(batch[k].numpy() for k in ("color0", "color1", "depth0", "depth1", "calib"))


def _configs(track):
    preset, kwargs = TRACKS[track]
    if preset:
        return (dataclasses.replace(get_preset(preset), uncer_prop=True),
                dataclasses.replace(jp.get_preset(preset), uncer_prop=True))
    return TrackerConfig(uncer_prop=True, **kwargs), JaxConfig(uncer_prop=True, **kwargs)


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is float64: the JAX tracker casts the
    encoder's outputs to ``jnp.float32`` for the solve, and a float64 run
    must keep them in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _pair(track, seed=3, float64=False):
    """(the port tracker, the JAX tracker, its variables), from the port's
    seeded weights; in float64 the port runs the kernels' plain versions."""
    cfg, jcfg = _configs(track)
    port = LeastSquareTracking(cfg, plain_kernels=float64).reset_parameters(seed)
    conv = convert_state_dict(port.state_dict())
    assert not conv["unmapped"]
    v = {c: conv[c] for c in ("params", "batch_stats")}
    if float64:
        return (port.double(), JaxTracker(cfg=jcfg, dtype=jnp.float64),
                jax.tree.map(lambda a: np.asarray(a, np.float64), v))
    return port, JaxTracker(cfg=jcfg), v


def _info_close(got, ref, rtol=INFO_RTOL):
    """Each 6x6 matrix within ``rtol`` of its largest entry."""
    got, ref = got.detach().numpy().reshape(-1, 36), np.asarray(ref).reshape(-1, 36)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=rtol * np.abs(r).max(), rtol=0)


def _outputs(port, net, v, ins, float64):
    """Both packages' eval ``((R, t), info)`` and training ``(pyr_R, pyr_t,
    sigma_ksi)``, the port's as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        if float64:
            mp.setattr(jtracker, "jnp", _Float64Numpy())
        ref_eval = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(
            v, *map(jnp.asarray, ins))
        ref_train = jax.jit(lambda v, *a: net.apply(v, *a, train=True, mutable=[
            "batch_stats"]))(v, *map(jnp.asarray, ins))[0]
    with torch.inference_mode():
        (R, t), info = port.eval()(*map(torch.from_numpy, ins))
        got_train = port.train()(*map(torch.from_numpy, ins))
    return ((R, t), info), got_train, ref_eval, ref_train


@pytest.mark.parametrize("track", sorted(TRACKS))
def test_uncer_prop_outputs_match_jax(track):
    """In float64 both packages: on these smooth scenes they agree within
    3e-10 (U_FC's training forward; the rest within 1e-14); on
    uniform-noise images the IC, ICP and U_FC solves are chaotic even in
    float64 (the port and JAX 3e-4 to 1 rad apart), and in float32 on
    these scenes too (ICP's degenerate plane, U_FC's 4x5 level 3)."""
    port, net, v = _pair(track, float64=True)
    assert port.cfg.track_type == track
    ins = [a.astype(np.float64) for a in _inputs()]
    ((R, t), info), got_train, ((Rj, tj), info_j), ref_train = _outputs(port, net, v, ins, True)
    assert info.shape == (B, 6, 6) and info.dtype == torch.float64
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-8, rtol=0)
    _info_close(info, info_j, 1e-8)
    pyr_R, pyr_t, sigma = got_train
    n = 5 if port.cfg.predicts_init_pose else 4
    assert sigma.shape == (B, n, 6, 6) and pyr_R.shape == (B, n, 3, 3)
    np.testing.assert_allclose(pyr_R.numpy(), np.asarray(ref_train[0]), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pyr_t.numpy(), np.asarray(ref_train[1]), atol=1e-8, rtol=0)
    _info_close(sigma, ref_train[2], 1e-8)
    if n == 5:  # the predicted initial pose's information is the identity
        torch.testing.assert_close(sigma[:, 0], torch.eye(6, dtype=sigma.dtype).expand(B, 6, 6),
                                   rtol=0, atol=0)


def test_uncer_prop_u_ic_matches_jax_in_float32():
    """The main path's track, U_IC with the fused ICP term, also in
    float32: poses within 1e-4, information matrices within 1e-4 of their
    largest entry (measured within 3.4e-6)."""
    port, net, v = _pair("U_IC")
    ((R, t), info), (pyr_R, pyr_t, sigma), ((Rj, tj), info_j), ref_train = _outputs(
        port, net, v, _inputs(), False)
    for got, ref in ((R, Rj), (t, tj), (pyr_R, ref_train[0]), (pyr_t, ref_train[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE_ATOL, rtol=0)
    _info_close(info, info_j)
    _info_close(sigma, ref_train[2])


def test_validating_an_uncer_prop_tracker_stops_as_the_jax_loop():
    """``evaluate_two_view`` unpacks the forward as ``R, t``; an
    ``uncer_prop`` tracker's eval forward is ``((R, t), JtWJ)``, and the JAX
    loop stops with numpy's ``ValueError`` on the ragged ``(R, t)`` pair.
    The port stops with a ``ValueError`` at the same point."""
    ins = _inputs()
    batch = dict(zip(("color0", "color1", "depth0", "depth1", "calib"), ins),
                 transform=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
                 pad_mask=np.ones(B, bool))
    port = LeastSquareTracking(apply_overrides(get_preset("feature"), ["uncer_prop=1"]))
    port.reset_parameters(1)
    net = JaxTracker(cfg=dataclasses.replace(jp.get_preset("feature"), uncer_prop=True))
    conv = convert_state_dict(port.state_dict())
    v = {c: conv[c] for c in ("params", "batch_stats")}

    jax_forward = jax.jit(lambda *a: net.apply(v, *a, train=False))

    with pytest.raises(ValueError, match="inhomogeneous"):
        je.evaluate_two_view([batch], jax_forward)
    with pytest.raises(ValueError, match="uncer_prop"):
        pe.evaluate_two_view([batch], port, "cpu")


