"""The rule-scoring kernels' share of their roofline: the least time of
every dispatch's scoring (harness/roofline.py: rule_work, its output each
query's fetched top rules, not the score matrix) over the device time of
the scoring kernels (csrc/rule_match.cu) in the trace."""

KERNELS = ("rule_scores",)


def read(rec):
    return rec.roofline_pct("rules", *KERNELS)
