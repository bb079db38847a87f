"""``utils/debug.py`` (``--debug_nan``) and ``utils/logger.py``.

The JAX package's ``checked`` makes its jitted step raise at the first NaN
or Inf (``checkify.float_checks``); the port's raises
``NonFiniteError`` naming the module whose output first held one (or the
autograd node whose backward did).  A finite step runs unchanged under it.
``TeeLogger`` mirrors stdout to a file; ``MetricsLogger`` writes nothing
on a process that is not the main one, and its ``image`` goes to
TensorBoard where a writer exists and nowhere otherwise.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_torch.utils import logger as plogger
from deep_prob_feature_track_torch.utils.debug import NonFiniteError, checked

torch.set_num_threads(2)


def _state():
    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), cfg, seed=1,
                                  device="cpu")
    return cfg, state


def test_checked_step_names_the_first_module_with_a_nan():
    cfg, state = _state()
    step = checked(tt.make_train_step(cfg, 10), state.net)
    batch = tt.synthetic_batch(2, 16, 20, seed=1, device="cpu")
    batch["depth0"][0] = float("nan")
    with pytest.raises(NonFiniteError, match=r"module encoder\.net0\.0\.0 \(Conv2d\)"):
        step(state, batch)
    # the hooks are gone: the plain step runs on
    assert not any(m._forward_hooks for m in state.net.modules())


def test_checked_step_leaves_a_finite_step_as_it_is():
    results = []
    for wrap in (False, True):
        cfg, state = _state()
        step = tt.make_train_step(cfg, 10)
        step = checked(step, state.net) if wrap else step
        state, m = step(state, tt.synthetic_batch(2, 16, 20, seed=2, device="cpu"))
        results.append((m["loss"], [p.detach().clone() for p in state.net.parameters()]))
    assert torch.equal(results[0][0], results[1][0])
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    from chip_smoke import write_tum_sequence
    from deep_prob_feature_track_torch.data import tum as ptum

    write_tum_sequence(str(tmp_path / "data" / "seq"), n=4)
    monkeypatch.setattr(ptum, "TUM_TRAINVAL", {"fx": ["seq"]})
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
    return str(tmp_path / "data")


def test_train_cli_debug_nan_raises_on_a_nan_batch(data_root, tmp_path, monkeypatch):
    """A NaN depth map in the first batch: with ``--debug_nan`` the CLI
    stops at it, naming the module; without it the step runs on."""
    to_device = tt.to_device

    def nan_depth(batch, device):
        out = to_device(batch, device)
        out["depth0"][0] = float("nan")
        return out

    monkeypatch.setattr(tt, "to_device", nan_depth)
    args = ["--data_root", data_root, "--keyframes", "1", "--batch_size", "2",
            "--image_resize", "0.1", "--epochs", "1", "--max_steps_per_epoch", "1", "--no_val",
            "--checkpoint_folder", str(tmp_path / "logs"), "--device", "cpu"]
    with pytest.raises(NonFiniteError, match="module encoder"):
        ptr.main([*args, "--debug_nan"])
    assert ptr.main(args) == 0


def test_tee_logger_mirrors_stdout(tmp_path, capsys):
    log = plogger.TeeLogger(str(tmp_path / "sub" / "log.txt"))
    print("hello tee")
    log.flush()
    log.close()
    print("after")
    assert (tmp_path / "sub" / "log.txt").read_text() == "hello tee\n"
    assert capsys.readouterr().out == "hello tee\nafter\n"
    assert sys.stdout is not log


def test_metrics_logger_writes_on_the_main_process_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
    quiet = plogger.MetricsLogger(str(tmp_path / "rank1"), is_main_process=False)
    quiet.scalar("train/loss", 1.0, 0)
    quiet.image("img", np.zeros((4, 4, 3), np.uint8), 0)
    quiet.close()
    assert not os.path.exists(tmp_path / "rank1")
    main = plogger.MetricsLogger(str(tmp_path / "rank0"))
    main.scalar("train/loss", 2.5, 3)
    main.close()
    (line,) = (tmp_path / "rank0" / "metrics.jsonl").read_text().splitlines()
    assert {k: v for k, v in json.loads(line).items() if k != "t"} == {
        "tag": "train/loss", "value": 2.5, "step": 3}


def test_metrics_logger_image_goes_to_tensorboard_where_it_imports(tmp_path, monkeypatch):
    calls = []

    class Writer:
        def add_image(self, *args, **kwargs):
            calls.append((args, kwargs))

        def close(self):
            pass

    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)
    none = plogger.MetricsLogger(str(tmp_path / "a"))
    none.image("img", np.zeros((4, 4, 3), np.uint8), 1)  # no TensorBoard: a no-op
    none.close()
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: Writer())
    tb = plogger.MetricsLogger(str(tmp_path / "b"))
    img = np.ones((4, 5, 3), np.float32)
    tb.image("vis/residual", img, 7)
    tb.close()
    assert len(calls) == 1
    (tag, got, step), kwargs = calls[0]
    assert tag == "vis/residual" and got is img and step == 7 and kwargs == {"dataformats": "HWC"}
