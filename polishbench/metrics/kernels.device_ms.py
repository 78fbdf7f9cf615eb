"""Milliseconds per polish that the card spent in the port's five
hand-written kernels (``csrc/*.cu``: kernel 1 ``poa_dp_kernel``, 3
``poa_tb_kernel``, 2 ``heaviest_bundle_kernel``, 4 ``poa_rank_kernel``,
which also runs the step head, and 5 ``poa_merge_kernel``), from the
window's ``torch.profiler`` trace.  The tile program's torch ops, copies
and sets are left out: they are not this layer's."""
import re

KERNELS = re.compile(r"\b(poa_dp_kernel|poa_tb_kernel|heaviest_bundle_kernel"
                     r"|poa_rank_kernel|poa_merge_kernel)\b")


def read(t):
    ks = [(n, s, e) for n, s, e in t.kernels() if KERNELS.search(n)]
    if not t.polishes or not ks:
        return None
    return 1e3 * sum(e - s for _n, s, e in ks) / t.polishes
