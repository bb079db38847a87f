"""The rematerialized training modes: ``remat_gn`` (each Gauss-Newton
iteration under a checkpoint) and ``remat_encoder`` (each encoder pass
under one).

A checkpoint's replay runs the same ops on the same inputs, so a step with
the modes must give the bits of the step without them: the loss, every
gradient leaf, the parameters and Adam moments after the update, the
BatchNorm running statistics and ``num_batches_tracked`` (which the replay
must not move a second time), and ``skipped``.  Held bit for bit on the CPU
(the kernels' plain versions) for ``feature`` and ``feature_icp`` and
``DeepIC`` (its damping MLP inside the rematted IC loop) at 32x40, for
U_FC with the learned ``MultiScale2w`` estimator (its BatchNorm inside the
rematted U_FC loop) at 64x80 (at 32x40 that step is chaotic in
float32, ``tests/test_torch_port_ufc_train.py``), with ``accum_steps=2``
and the non-finite guard, on a one-rank mesh, and for the ICP level solves
with gradients to their inputs.  The train CLI's mode flags are held in
``tests/test_torch_port_cli_train.py``.

The step against the JAX package's ``DPFT_TRAIN_LOOP=scan_remat`` step is
in ``tests/test_torch_port_remat_jax.py``.
"""

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models import encoder as tenc
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.parallel import mesh as pmesh
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_torch.training import train as tt

torch.set_num_threads(2)

MODES = {"remat_gn": {"remat_gn": True},
         "remat_gn+remat_encoder": {"remat_gn": True, "remat_encoder": True}}
UFC_MEST = ("direction=forward", "mest_type=MultiScale2w", "train_init_pose=false")
# config -> (preset, overrides, B, H, W)
CONFIGS = {"feature": ("feature", (), 2, 32, 40),
           "feature_icp": ("feature_icp", (), 2, 32, 40),
           "DeepIC": ("DeepIC", (), 2, 32, 40),
           "U_FC MultiScale2w": ("feature", UFC_MEST, 2, 64, 80)}


def _cfg(name):
    preset, overrides, *_ = CONFIGS[name]
    return apply_overrides(get_preset(preset), list(overrides))


def _snapshot(state, metrics):
    """Every tensor a step leaves behind, by name, cloned."""
    out = {f"metric {k}": v.detach().clone() for k, v in metrics.items()}
    out.update({f"grad {k}": p.grad.clone() for k, p in state.net.named_parameters()
                if p.grad is not None})
    out.update({f"state {k}": v.clone() for k, v in state.net.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": v.clone() for k, v in st.items() if torch.is_tensor(v)})
    return out


def _steps(name, modes, accum=1, guard=False, nan_second=False, mesh=None):
    """One step (two with ``nan_second``: the second batch has a NaN depth
    map) of config ``name`` from seeded weights on a seeded batch: the
    snapshot after each."""
    _, _, B, H, W = CONFIGS[name]
    cfg = tt.TrainConfig(accum_steps=accum)
    state = tt.create_train_state(LeastSquareTracking(_cfg(name), **modes), cfg, seed=1,
                                  device="cpu")
    step = tt.make_train_step(cfg, 100, mesh=mesh, guard_nonfinite=guard)
    snaps = []
    for seed in ((3, 4) if nan_second else (3,)):
        batch = tt.synthetic_batch(B, H, W, seed=seed, device="cpu")
        if seed == 4:
            batch["depth0"][0, 0, 5, 7] = float("nan")
        state, metrics = step(state, batch)
        snaps.append(_snapshot(state, metrics))
    return snaps


_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}


def _bits(t):
    """``t`` viewed as integers where it is floating point: equal bits are
    equal integers, NaN included."""
    return t.view(_INT_OF[t.dtype]) if t.is_floating_point() else t


def _assert_same_bits(got, ref):
    assert got.keys() == ref.keys()
    differ = [k for k in ref if not torch.equal(_bits(got[k]), _bits(ref[k]))]
    assert not differ, differ
    # BatchNorm counted each forward's batch once
    assert any(k.endswith("num_batches_tracked") for k in ref)


_UNROLLED = {}


def _unrolled(name, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _UNROLLED:
        _UNROLLED[key] = _steps(name, {}, **kw)
    return _UNROLLED[key]


@pytest.mark.parametrize("modes", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rematted_step_equals_unrolled_step_bit_for_bit(name, modes):
    (got,), (ref,) = _steps(name, MODES[modes]), _unrolled(name)
    _assert_same_bits(got, ref)


@pytest.mark.parametrize("modes", sorted(MODES))
def test_rematted_accumulated_guarded_steps_equal_unrolled_bit_for_bit(modes):
    """``accum_steps=2`` with the guard: a step, then a skipped step on a
    batch with a NaN depth map."""
    kw = {"accum": 2, "guard": True, "nan_second": True}
    got, ref = _steps("feature", MODES[modes], **kw), _unrolled("feature", **kw)
    assert not ref[0]["metric skipped"] and ref[1]["metric skipped"]
    for g, r in zip(got, ref):
        _assert_same_bits(g, r)


def test_rematted_step_on_a_one_rank_mesh_equals_unrolled_bit_for_bit():
    mesh = pmesh.make_mesh("cpu")
    try:
        (got,) = _steps("feature", MODES["remat_gn+remat_encoder"], mesh=mesh)
    finally:
        pmesh.destroy()
    _assert_same_bits(got, _unrolled("feature")[0])


def test_remat_replays_every_iteration_and_encoder_pass(monkeypatch):
    """The backward recomputes: the training forward of ``feature`` samples
    with K2's function 12 times (3 iterations at 4 levels) and encodes
    twice; with ``remat_gn`` the replays sample 12 more times, with
    ``remat_encoder`` they encode twice more; eval replays nothing."""
    calls = {"grads": 0, "encoder": 0}
    grads, enc_forward = tw.gather_twohot_grads, tenc.FeaturePyramid.forward

    def counting_grads(*a):
        calls["grads"] += 1
        return grads(*a)

    def counting_encoder(self, x):
        calls["encoder"] += 1
        return enc_forward(self, x)

    monkeypatch.setattr(tw, "gather_twohot_grads", counting_grads)
    monkeypatch.setattr(tenc.FeaturePyramid, "forward", counting_encoder)
    for modes, expected in (({}, (12, 2)), (MODES["remat_gn"], (24, 2)),
                            (MODES["remat_gn+remat_encoder"], (24, 4))):
        calls.update(grads=0, encoder=0)
        _steps("feature", modes)
        assert (calls["grads"], calls["encoder"]) == expected, modes
    net = LeastSquareTracking(get_preset("feature"), remat_gn=True, remat_encoder=True)
    batch = tt.synthetic_batch(2, 32, 40, seed=3, device="cpu")
    calls.update(grads=0, encoder=0)
    R, t = net(*(batch[k] for k in ("color0", "color1", "depth0", "depth1", "calib")))
    (R.sum() + t.sum()).backward()
    assert calls == {"grads": 12, "encoder": 1}  # the eval forward: one stacked pass


def test_autograd_functions_keep_no_tensor_outside_save_for_backward():
    """A checkpoint drops and replays what ``save_for_backward`` holds; a
    tensor kept on ``ctx`` otherwise would stay alive through the step.
    The gather (``BilinearGather``: the plane's shape, ``plain``) and K6
    (``FusedJtJ``: the sign) keep none."""
    net = LeastSquareTracking(get_preset("feature"), remat_gn=True).reset_parameters(1).train()
    loss = tt.compute_loss(net, tt.TrainConfig(),
                           tt.synthetic_batch(2, 32, 40, seed=3, device="cpu"))
    seen, stack, custom = set(), [loss.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if isinstance(node, torch.autograd.function.BackwardCFunction):
            name = type(node).__name__
            custom[name] = custom.get(name, 0) + 1
            assert not [k for k, v in vars(node).items() if torch.is_tensor(v)], name
        stack.extend(f for f, _ in node.next_functions)
    assert custom == {"BilinearGatherBackward": 12, "FusedJtJBackward": 12}


def _icp_inputs():
    rng = np.random.RandomState(0)
    B, H, W = 2, 24, 32
    y, x = np.mgrid[:H, :W]
    depth = (1.5 + 0.3 * np.sin(x / 5.0) * np.cos(y / 7.0) + 0.01 * rng.rand(B, 1, H, W))
    d0 = torch.from_numpy(depth.astype(np.float32))
    d1 = torch.from_numpy((depth * 1.01).astype(np.float32))
    K = torch.tensor([[20.0, 20.0, 15.5, 11.5]] * B)
    R = torch.eye(3).repeat(B, 1, 1)
    t = torch.tensor([[0.01, -0.005, 0.02]] * B)
    return d0, d1, K, (R, t)


@pytest.mark.parametrize("solve", ["icp inverse", "icp forward", "icp point"])
def test_rematted_icp_level_solves_give_the_same_input_gradients(solve):
    def run(remat):
        d0, d1, K, (R, t) = _icp_inputs()
        ins = [d0.requires_grad_(), d1.requires_grad_(), t.requires_grad_()]
        if solve == "icp point":
            (R_, t_), JtJ = ttr.tr_icp_point_level((R, t), d0, d1, K, max_iter=4, remat=remat)
        else:
            (R_, t_), _, JtJ = ttr.tr_icp_level((R, t), d0, d1, K, direction=solve.split()[1],
                                                remat=remat)
        loss = R_.square().sum() + t_.square().sum() + 1e-6 * JtJ.sum()
        return [loss.detach(), *torch.autograd.grad(loss, ins)]

    for got, ref in zip(run(True), run(False)):
        assert torch.equal(got, ref)
