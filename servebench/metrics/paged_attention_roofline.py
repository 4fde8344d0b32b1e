"""``csrc/paged_attention.cu``'s share of its roofline (see
``_roofline.py``): its launches are the split decode and its merge, the
kernels whose names hold ``paged_decode``, ``paged_split`` or
``combine_kernel`` (the merge is the dense decode's too, which the paged
path never runs)."""
from servebench.metrics import _roofline


def read(run):
    return _roofline.share(run, _roofline.decode_bound_s(run),
                           ("paged_decode", "paged_split", "combine_kernel"))
