"""The share of the mining window in which no operation ran on the device
(torch.profiler's CUDA activity, merged), averaged over the cards."""


def read(rec):
    return rec.idle_pct()
