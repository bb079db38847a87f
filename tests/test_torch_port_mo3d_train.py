"""PyTorch port vs the JAX package: the train CLI with ``--dataset
MovingObjects3D`` (the object's relative motion, its masks in every batch).

The fixture of ``tests/test_torch_port_mo3d.py`` (128x160, read at 0.25,
B=2).  Both CLIs start from the same weights: the port's seeded init at the
CLIs' ``--seed`` 1, carried to flax by ``convert_state_dict`` and handed to
the JAX CLI's ``create_train_state``.  Both see the same batches: one
keyframe gap (``random.choice`` of one gap returns it, whatever the stream)
and the colour jitter off in both packages, since the JAX CLI draws one
example batch for flax's init before training and the port's seeded init
draws none (ROADMAP, deviations).  Tolerances: the first step's loss within
3e-4 relative of the JAX CLI's: on this batch (a random init, most of it
outside the object) rounding alone moves the float32 loss 6.8e-5 (the
port) and 7.2e-5 (JAX) from the port's float64 loss, on either side of it;
the second's within 1e-3 (after one Adam step from gradients that agree
within the 5e-3 envelope of ``tests/test_torch_port_train_jax.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data import moving_objects as pmo
from deep_prob_feature_track_torch.data import transforms as ptf
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_torch.utils import logger as plogger
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu.apps import train as jtr
from deep_prob_feature_track_tpu.data import moving_objects as jmo
from deep_prob_feature_track_tpu.data import transforms as jtf
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import train as jt
from deep_prob_feature_track_tpu.utils import logger as jlogger

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_mo3d import CATEGORIES, write_fixture  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("mo3d"))


@pytest.fixture
def cli_env(monkeypatch):
    """Both packages' categories patched to the fixture's sequences, their
    loggers without TensorBoard (importing its writer imports TensorFlow)
    and their colour jitter off."""
    for mod in (pmo, jmo):
        monkeypatch.setattr(mod, "CATEGORIES", CATEGORIES)
    for mod in (plogger, jlogger):
        monkeypatch.setattr(mod, "_tb_writer", lambda logdir: None)
    for mod in (ptf, jtf):
        monkeypatch.setattr(mod.ColorAugment, "__call__", lambda self, imgs: imgs)


def _args(root, folder, *extra):
    return ["--dataset", "MovingObjects3D", "--data_root", root, "--keyframes", "1",
            "--batch_size", "2", "--image_resize", "0.25", "--epochs", "1",
            "--max_steps_per_epoch", "2", "--checkpoint_folder", str(folder), *extra]


def _recording(monkeypatch, mod, losses):
    """Record each step's loss of the steps ``mod.make_train_step`` makes."""
    make = mod.make_train_step

    def recording_make(*a, **kw):
        step = make(*a, **kw)

        def recording_step(state, batch):
            assert "obj_mask0" in batch and "obj_mask1" in batch
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return recording_step
    monkeypatch.setattr(mod, "make_train_step", recording_make)


def test_train_cli_matches_the_jax_cli(root, cli_env, monkeypatch, tmp_path):
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(1)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    monkeypatch.setattr(jt, "create_train_state", lambda net, optimizer, example, seed=1:
                        jt.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                      batch_stats=v["batch_stats"],
                                      opt_state=optimizer.init(v["params"])))
    monkeypatch.setenv("DPFT_TRAIN_LOOP", "scan_remat")  # the unrolled loop's step, faster
    jax_losses, port_losses = [], []
    _recording(monkeypatch, jt, jax_losses)
    _recording(monkeypatch, tt, port_losses)
    assert jtr.main(_args(root, tmp_path / "jax", "--no_val")) == 0
    assert ptr.main(_args(root, tmp_path / "port", "--no_val", "--device", "cpu")) == 0
    assert len(jax_losses) == len(port_losses) == 2
    assert np.isfinite(port_losses).all()
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=3e-4)
    np.testing.assert_allclose(port_losses[1], jax_losses[1], rtol=1e-3)
    (logdir,) = (tmp_path / "port").iterdir()
    assert logdir.name.startswith("MovingObjects3D_")
    final = checkpoints.restore_variables(str(logdir / "checkpoint_epoch1.pt"))
    assert final["step"] == 2


def test_train_cli_validation_on_mo3d_stops_as_the_jax_cli(root, cli_env, tmp_path):
    """Without ``--no_val`` the validation loaders read the test objects
    (boat, motorbike) from the validation split, which holds only training
    categories: they are empty, the JAX CLI's ``info["epes"]`` meets a
    result whose metric keys were dropped, and the port stops the same way,
    after its first checkpoint."""
    loaders = je.create_eval_loaders("MovingObjects3D", "validation", [1], 2, root=root)
    assert list(loaders) == ["boat_keyframe_1", "motorbike_keyframe_1"]
    assert all(len(loader) == 0 for loader in loaders.values())
    assert "epes" not in je.evaluate_two_view(next(iter(loaders.values())), None)
    with pytest.raises(KeyError, match="epes"):
        ptr.main(_args(root, tmp_path, "--device", "cpu"))
    (logdir,) = tmp_path.iterdir()
    assert [p.name for p in logdir.glob("*.pt")] == ["checkpoint_epoch0.pt"]
