"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
(DESIGN.md §10).

=====================  =========================================  ====================
kernel (LAUNCHES key)  replaces (JAX package, Pallas)              runtime family
=====================  =========================================  ====================
support_count          support_count.py:_support_count_kernel      mining ``jnp``
support_count_matmul   support_count.py:_support_count_matmul_...  mining ``matmul``
vertical_count         vertical_count.py:_vertical_count_kernel    mining ``vertical``
vertical_count_matmul  vertical_count.py:_vertical_matmul_kernel   mining ``vertical_matmul``
delta_count            delta_count.py:_delta_count_kernel          streaming ``jnp``
delta_count_matmul     delta_count.py:_delta_count_matmul_kernel   streaming ``matmul``
rule_scores            rule_match.py:_rule_scores_kernel           serving ``jnp``
rule_scores_matmul     rule_match.py:_rule_scores_matmul_kernel    serving ``matmul``
=====================  =========================================  ====================

The sources are in ``repro_torch/csrc/`` and are built at first launch
(:mod:`repro_torch.kernels._build`).  ``LAUNCHES`` counts each kernel's
launches.
"""

from ._build import LAUNCHES, build_all, reset_launches
from .delta_count import (delta_count_matmul, delta_count_matmul_plain,
                          delta_count_popcount, delta_count_popcount_plain)
from .ops import support_count as support_count_host
from .rule_match import (rule_scores, rule_scores_matmul,
                         rule_scores_matmul_plain, rule_scores_plain)
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
    "delta_count": (delta_count_popcount, delta_count_popcount_plain),
    "delta_count_matmul": (delta_count_matmul, delta_count_matmul_plain),
    "rule_scores": (rule_scores, rule_scores_plain),
    "rule_scores_matmul": (rule_scores_matmul, rule_scores_matmul_plain),
}

__all__ = ["KERNELS", "LAUNCHES", "build_all", "reset_launches",
           "support_count", "support_count_plain", "support_count_matmul",
           "support_count_matmul_plain", "support_count_host",
           "vertical_count", "vertical_count_plain", "vertical_count_matmul",
           "vertical_count_matmul_plain", "delta_count_popcount",
           "delta_count_popcount_plain", "delta_count_matmul",
           "delta_count_matmul_plain", "rule_scores", "rule_scores_plain",
           "rule_scores_matmul", "rule_scores_matmul_plain"]
