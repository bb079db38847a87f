"""Hand-written CUDA kernels of the port, each beside its plain version.

- ``gather_twohot`` (K1): bilinear sample of a channels-last plane.
- ``gather_twohot_grads`` (K2): K1 plus the within-cell derivative maps.
- ``splat_twohot`` (K3): the operand cotangent of the sample (K1's adjoint).
- ``gather_tiles`` (K4) and ``gather_tiles_grads`` (K5): K1's and K2's
  functions on a 2-D sample grid, staged per output tile, and ``use_tiles``,
  the route that picks them where the JAX package picks its tile kernels.
- ``fused_jtj_jtr`` (K6): factored JtWJ / JtR reduction, and ``FusedJtJ``,
  its autograd Function.

Importing this package builds nothing: ``loader`` compiles a kernel at its
first launch.
"""

from .gather import gather_twohot, gather_twohot_cuda, gather_twohot_ref
from .gather_grads import gather_twohot_grads, gather_twohot_grads_cuda, gather_twohot_grads_ref
from .jtj import FusedJtJ, fused_jtj_jtr, fused_jtj_jtr_cuda, jtj_jtr_ref
from .loader import LAUNCHES, reset_launches
from .splat import splat_twohot, splat_twohot_cuda, splat_twohot_ref
from .tiles import (
    gather_tiles,
    gather_tiles_cuda,
    gather_tiles_grads,
    gather_tiles_grads_cuda,
    gather_tiles_grads_ref,
    gather_tiles_ref,
    use_tiles,
)

__all__ = [
    "FusedJtJ",
    "LAUNCHES",
    "fused_jtj_jtr",
    "fused_jtj_jtr_cuda",
    "gather_tiles",
    "gather_tiles_cuda",
    "gather_tiles_grads",
    "gather_tiles_grads_cuda",
    "gather_tiles_grads_ref",
    "gather_tiles_ref",
    "gather_twohot",
    "gather_twohot_cuda",
    "gather_twohot_grads",
    "gather_twohot_grads_cuda",
    "gather_twohot_grads_ref",
    "gather_twohot_ref",
    "jtj_jtr_ref",
    "reset_launches",
    "splat_twohot",
    "splat_twohot_cuda",
    "splat_twohot_ref",
    "use_tiles",
]
