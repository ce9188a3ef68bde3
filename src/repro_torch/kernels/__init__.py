"""Counting kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version (DESIGN.md §10).

=====================  =========================================  ====================
wrapper                replaces (JAX package, Pallas)              runtime family
=====================  =========================================  ====================
support_count          support_count.py:_support_count_kernel      ``jnp``
support_count_matmul   support_count.py:_support_count_matmul_...  ``matmul``
vertical_count         vertical_count.py:_vertical_count_kernel    ``vertical``
vertical_count_matmul  vertical_count.py:_vertical_matmul_kernel   ``vertical_matmul``
=====================  =========================================  ====================

The sources are in ``repro_torch/csrc/`` and are built at first launch
(:mod:`repro_torch.kernels._build`).  ``LAUNCHES`` counts each kernel's
launches.
"""

from ._build import LAUNCHES, build_all, reset_launches
from .ops import support_count as support_count_host
from .support_count import (support_count, support_count_matmul,
                            support_count_matmul_plain, support_count_plain)
from .vertical_count import (vertical_count, vertical_count_matmul,
                             vertical_count_matmul_plain, vertical_count_plain)

# kernel name → (wrapper, plain version); the names are LAUNCHES' keys
KERNELS = {
    "support_count": (support_count, support_count_plain),
    "support_count_matmul": (support_count_matmul, support_count_matmul_plain),
    "vertical_count": (vertical_count, vertical_count_plain),
    "vertical_count_matmul": (vertical_count_matmul,
                              vertical_count_matmul_plain),
}

__all__ = ["KERNELS", "LAUNCHES", "build_all", "reset_launches",
           "support_count", "support_count_plain", "support_count_matmul",
           "support_count_matmul_plain", "support_count_host",
           "vertical_count", "vertical_count_plain", "vertical_count_matmul",
           "vertical_count_matmul_plain"]
