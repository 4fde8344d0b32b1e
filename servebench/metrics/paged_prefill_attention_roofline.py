"""``csrc/paged_prefill_attention.cu``'s share of its roofline (see
``_roofline.py``): its launches are the kernels whose names hold
``paged_prefill``."""
from servebench.metrics import _roofline


def read(run):
    return _roofline.share(run, _roofline.prefill_bound_s(run),
                           ("paged_prefill",))
