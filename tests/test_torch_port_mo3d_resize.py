"""The PIL-rule nearest resize that MovingObjects3D items take
(``data/io.py::resize_nearest_pil``) against PIL itself, bit for bit, for
8-bit and 16-bit images.  The items are held against the JAX package in
``tests/test_torch_port_mo3d.py``.
"""

import numpy as np
import pytest
from PIL import Image

from deep_prob_feature_track_torch.data import io as pio


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("size,out", [((480, 640), (120, 160)), ((480, 640), (240, 320)),
                                      ((97, 131), (24, 33)), ((97, 131), (48, 66)),
                                      ((689, 564), (230, 188)), ((104, 182), (31, 55))])
def test_resize_nearest_pil_matches_pil(size, out, dtype):
    """PIL picks other source pixels for 8-bit and 16-bit images where the
    step is not exact; both against PIL, on images that hold their own
    coordinates."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((yy * 7 + xx * 3) % (251 if dtype == np.uint8 else 65521)).astype(dtype)
    pil = Image.fromarray(img) if dtype == np.uint8 else \
        Image.fromarray(img.astype(np.int32), mode="I").convert("I;16")
    ref = np.asarray(pil.resize((out[1], out[0]), Image.NEAREST))
    got = pio.resize_nearest_pil(img, *out)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
