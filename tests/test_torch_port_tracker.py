"""PyTorch port vs the JAX package: the U_IC level solve, the full eval
forward of the feature preset, and the tracking service on the CPU.

Weights are the flax ``PRNGKey(7)`` init carried over by ``from_flax``;
inputs are those of ``tests/test_golden.py``.  Tolerances: atol 1e-4 on R
and t for the forward (the acceptance bound), 2e-5 against the golden
file (its own bound, tests/test_golden.py), and 1e-5 for one level solve.
"""

import copy
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps.serve import build_service, build_tracker, make_handler
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.solvers.trust_region import tr_uic_level
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

torch.set_num_threads(2)

B, H, W = 2, 32, 40
GOLDEN = __file__.rsplit("/", 1)[0] + "/golden_forward.npz"
# max |dR|, |dt| between the port and the JAX forward that routes the eval
# gather through the Pallas interpreter (bf16x3 "high" precision), measured
# on these inputs on the CPU: 1.8e-7 / 7.4e-8 (against the XLA gather path:
# 1.8e-7 / 4.3e-8).  Bounded at 1e-5, well under the forward's 1e-4.
PALLAS_ATOL = 1e-5


def _golden_inputs():
    rng = np.random.RandomState(42)
    return (
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def models():
    """(JAX tracker, its PRNGKey(7) variables, the port tracker with them)."""
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(a) for a in _golden_inputs()]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    return net, v, port


@pytest.fixture(scope="module")
def port_pose(models):
    with torch.inference_mode():
        R, t = models[2](*map(torch.from_numpy, _golden_inputs()))
    return R.numpy(), t.numpy()


def _jax_pose(models):
    """JAX forward, jitted afresh so it traces under the current env."""
    net, v, _ = models
    fwd = jax.jit(lambda v, *a: net.apply(v, *a, train=False))
    R, t = fwd(v, *map(jnp.asarray, _golden_inputs()))
    return np.asarray(R), np.asarray(t)


def test_tr_uic_level_matches_jax(rng):
    h, w = 16, 20
    K = np.tile([[13.0, 13.0, 9.75, 7.75]], (B, 1)).astype(np.float32)
    x0 = rng.randn(B, 8, h, w).astype(np.float32)
    x1 = (x0 + 0.1 * rng.randn(B, 8, h, w)).astype(np.float32)
    s0 = np.exp(rng.uniform(-1, 1, (B, 1, h, w))).astype(np.float32)
    s1 = np.exp(rng.uniform(-1, 1, (B, 1, h, w))).astype(np.float32)
    d0 = rng.uniform(0.3, 1.5, (B, 1, h, w)).astype(np.float32)
    d1 = rng.uniform(0.3, 1.5, (B, 1, h, w)).astype(np.float32)
    # a non-identity start: at identity warp coordinates land exactly on
    # pixel centres and cell edges, where last-bit differences flip cells
    R0 = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                         jnp.float32)))
    t0 = np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, -0.01]], np.float32)
    args = (x0, x1, d0, d1, K, s0, s1)
    level = jax.jit(lambda p, *a: jtr.tr_uic_level(p, *a, max_iter=3, remove_tru_sigma=True))
    (Rj, tj), _, JtWJ_j = level((jnp.asarray(R0), jnp.asarray(t0)), *map(jnp.asarray, args))
    for plain in (False, True):
        (R, t), _, JtWJ = tr_uic_level((torch.from_numpy(R0), torch.from_numpy(t0)),
                                    *map(torch.from_numpy, args), max_iter=3,
                                    remove_tru_sigma=True, plain=plain)
        np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
        np.testing.assert_allclose(JtWJ.numpy(), np.asarray(JtWJ_j), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(JtWJ_j)).max())
    assert not np.allclose(R.numpy(), R0, atol=1e-4)  # the solve moved the pose


def test_forward_matches_jax(models, port_pose):
    R, t = port_pose
    Rj, tj = _jax_pose(models)
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-4)


def test_forward_matches_golden(port_pose):
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(port_pose[0], golden["feature_R"], atol=2e-5)
    np.testing.assert_allclose(port_pose[1], golden["feature_t"], atol=2e-5)


def test_forward_matches_jax_pallas_gather(models, port_pose, monkeypatch):
    monkeypatch.setenv("DPFT_PALLAS_GATHER", "1")
    monkeypatch.setenv("DPFT_PALLAS_INTERPRET", "1")
    Rj, tj = _jax_pose(models)
    np.testing.assert_allclose(port_pose[0], Rj, atol=PALLAS_ATOL)
    np.testing.assert_allclose(port_pose[1], tj, atol=PALLAS_ATOL)


def test_plain_kernels_flag_gives_same_pose_on_cpu(models, port_pose):
    plain = LeastSquareTracking(get_preset("feature"), plain_kernels=True)
    plain.load_state_dict(models[2].state_dict())
    with torch.inference_mode():
        R, t = plain(*map(torch.from_numpy, _golden_inputs()))
    np.testing.assert_array_equal(R.numpy(), port_pose[0])
    np.testing.assert_array_equal(t.numpy(), port_pose[1])


def test_build_tracker_loads_checkpoint(models, tmp_path):
    path = tmp_path / "feature.pt"
    torch.save(models[2].state_dict(), path)
    net = build_tracker("feature", str(path), device="cpu")
    assert not net.training
    for key, value in models[2].state_dict().items():
        torch.testing.assert_close(net.state_dict()[key], value, rtol=0, atol=0)
    # without a checkpoint: the seeded init, the same for the same seed
    a = build_tracker("feature", device="cpu", seed=4).state_dict()
    b = build_tracker("feature", device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_training_forward_is_not_ported(models):
    """``.train()`` selects the training forward, which is ported for the
    feature preset (``tests/test_torch_port_train.py``) and returns the
    5-pose pyramid; its uncertainty-propagating variant adds the levels'
    information matrices (``tests/test_torch_port_uncer.py``)."""
    net = copy.deepcopy(models[2]).train()
    pyr_R, pyr_t = net(*map(torch.from_numpy, _golden_inputs()))
    assert pyr_R.shape == (B, 5, 3, 3) and pyr_t.shape == (B, 5, 3)
    assert pyr_R.grad_fn is not None
    uncer = LeastSquareTracking(dataclasses.replace(get_preset("feature"), uncer_prop=True))
    uncer.load_state_dict(net.state_dict())
    pyr_R2, pyr_t2, sigma_ksi = uncer.train()(*map(torch.from_numpy, _golden_inputs()))
    assert sigma_ksi.shape == (B, 5, 6, 6)
    torch.testing.assert_close(pyr_t2, pyr_t, rtol=0, atol=0)


# ---------------------------------------------------------------- service


def _item(seed):
    rng = np.random.RandomState(seed)
    return {
        "color0": rng.rand(3, H, W).astype(np.float32),
        "color1": rng.rand(3, H, W).astype(np.float32),
        "depth0": rng.uniform(0.5, 3.0, (1, H, W)).astype(np.float32),
        "depth1": rng.uniform(0.5, 3.0, (1, H, W)).astype(np.float32),
        "calib": np.asarray([26.0, 26.0, 19.5, 15.5], np.float32),
    }


@pytest.fixture(scope="module")
def service():
    # a long flush timeout: three concurrent requests form one batch
    svc = build_service("feature", "", max_batch=3, H=H, W=W, device="cpu",
                        batch_timeout_ms=3000.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", svc
    httpd.shutdown()
    httpd.server_close()
    svc.stop()
    thread.join(10)


def test_service_concurrent_requests_match_direct_forward(service):
    _, svc = service
    n0 = svc.n_batches
    items = [_item(s) for s in range(3)]
    out = [None] * 3

    def call(i):
        out[i] = svc.submit(items[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads)
    assert svc.n_batches - n0 == 1
    # the batch-global reductions make a pose depend on its batch, not on
    # the order within it; the direct forward runs the same three requests
    net = LeastSquareTracking(get_preset("feature")).reset_parameters(0)
    stacked = [torch.from_numpy(np.stack([it[k] for it in items]))
               for k in ("color0", "color1", "depth0", "depth1", "calib")]
    with torch.inference_mode():
        R, t = net(*stacked)
    for i in range(3):
        np.testing.assert_allclose(out[i]["R"], R[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(out[i]["t"], t[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(out[i]["R"].T @ out[i]["R"], np.eye(3), atol=1e-5)


def test_service_http_roundtrip_and_errors(service):
    url, svc = service
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    buf = io.BytesIO()
    np.savez(buf, **_item(7))
    req = urllib.request.Request(url + "/track", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        out = np.load(io.BytesIO(r.read()))
    assert out["R"].shape == (3, 3) and np.isfinite(out["t"]).all()
    bad = urllib.request.Request(url + "/track", data=b"not-an-npz", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(bad, timeout=30)
    assert e.value.code == 400
    with pytest.raises(ValueError, match="served"):
        svc.submit({**_item(0), "color0": np.zeros((3, 8, 8), np.float32)})
