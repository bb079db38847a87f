"""PyTorch port vs the JAX package: the preset overrides that select the
U_FC track (``direction=forward``) and its variants, ``apply_overrides``
and ``_coerce``, equal to the JAX package's, and refusing what it refuses.
The track itself is held in ``tests/test_torch_port_ufc.py``.
"""

import dataclasses

import pytest

from deep_prob_feature_track_torch.models import presets as tp
from deep_prob_feature_track_tpu.models import presets as jp

UFC = ["direction=forward"]


@pytest.mark.parametrize("pairs", [
    UFC,
    ["direction=forward", "mest_type=MultiScale2w", "train_init_pose=false"],
    ["uncertainty_type=feature", "feature_extract=1by1", "max_iter_per_pyr=5"],
    ["scale_scaler=0.2", "scale_init_pose=0.5", "combine_icp=1"],
    ["scale_scaler=none", "remove_tru_sigma=off", "solver_type=Direct-ResVol"],
])
def test_apply_overrides_matches_jax(pairs):
    got = dataclasses.asdict(tp.apply_overrides(tp.get_preset("feature"), pairs))
    ref = dataclasses.asdict(jp.apply_overrides(jp.get_preset("feature"), pairs))
    assert got == {k: ref[k] for k in got}
    assert tp.apply_overrides(tp.get_preset("feature"), pairs) != tp.get_preset("feature")


@pytest.mark.parametrize("raw,current,optional", [
    ("true", False, False), ("off", True, False), ("7", 3, False), ("0.25", 0.5, False),
    ("4,5,", (1, 2), False), ("2.5", None, True), ("3", None, True), ("abc", None, True),
    ("None", "laplacian", False), ("null", 0.01, True),
])
def test_coerce_matches_jax(raw, current, optional):
    got = tp._coerce(raw, current, optional)
    ref = jp._coerce(raw, current, optional)
    assert got == ref and type(got) is type(ref)


def test_apply_overrides_refuses_what_the_jax_one_refuses():
    cfg = tp.get_preset("feature")
    for pairs in (["no_such_field=1"], ["direction"], ["train_init_pose=maybe"],
                  ["max_iter_per_pyr=three"]):
        with pytest.raises(SystemExit):
            tp.apply_overrides(cfg, pairs)
        with pytest.raises(SystemExit):
            jp.apply_overrides(jp.get_preset("feature"), pairs)
    assert tp.apply_overrides(cfg, []) == cfg and tp.apply_overrides(cfg, None) == cfg
    ufc = tp.apply_overrides(cfg, UFC)
    assert ufc.track_type == "U_FC" and cfg.track_type == "U_IC"
