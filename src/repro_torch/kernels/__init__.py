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
candidate_join         none (host numpy in both packages)          mining generation
candidate_prune        none (host numpy in both packages)          mining generation
=====================  =========================================  ====================

The last two (``csrc/candidate_gen.cu``, :mod:`.candidate_gen`) are the
join and the prune of candidate generation, which ``core/candidates.py``
runs on the runtime's device where it is a card.

The sources are in ``repro_torch/csrc/`` and are built at first launch
(:mod:`repro_torch.kernels._build`).  ``support_count``,
``support_count_matmul``, ``vertical_count_matmul`` and
``delta_count_matmul`` are modes of one tensor-core kernel,
``csrc/overlap_mma.cuh`` (single-bit products for ``support_count`` and
``support_count_matmul``, one instance, and, with the slab's signs as row
weights, ``delta_count_matmul``; int8 planes for ``vertical_count_matmul``),
fed the packed words.  ``LAUNCHES`` counts each kernel's
launches.
:func:`tuned_plan` (:mod:`~repro_torch.kernels.autotune`) times the families
of one kind against each other on the card and picks the winner behind every
``impl="auto"``.
"""

from ._build import LAUNCHES, build_all, reset_launches
from .autotune import tuned_blocks, tuned_plan
from .candidate_gen import (join_words, join_words_plain, prune_words,
                            prune_words_plain)
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
    "candidate_join": (join_words, join_words_plain),
    "candidate_prune": (prune_words, prune_words_plain),
}

__all__ = ["KERNELS", "LAUNCHES", "build_all", "reset_launches",
           "support_count", "support_count_plain", "support_count_matmul",
           "support_count_matmul_plain", "support_count_host",
           "vertical_count", "vertical_count_plain", "vertical_count_matmul",
           "vertical_count_matmul_plain", "delta_count_popcount",
           "delta_count_popcount_plain", "delta_count_matmul",
           "delta_count_matmul_plain", "rule_scores", "rule_scores_plain",
           "rule_scores_matmul", "rule_scores_matmul_plain", "join_words",
           "join_words_plain", "prune_words", "prune_words_plain",
           "tuned_blocks", "tuned_plan"]
