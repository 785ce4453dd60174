"""The plane-pass kernels' share of their byte roofline, in %: the bytes
their launches move at the memory peak, over those kernels' own device
time (not the window's).

Each launch of a kernel in :data:`BYTES_PER_AMPLITUDE` counts the bytes
one pass over the whole state of ``2**width`` amplitudes moves, each
amplitude two float32 values: read and written (16 B), read and written
as one probability (12 B, the sandwich kernel's probability form, its
template argument ``true``) or only written (8 B). Every such launch moves
its whole state at least once, so the share cannot pass 100% however the
passes are fused or tiled. Device operations of no kernel in the table
(PyTorch's own, such as ``|psi|^2`` and the reductions) count in neither
the bytes nor the time; a trace with no kernel of the table gives None.
"""

from __future__ import annotations

import re
from typing import Optional

from benchmark.metrics import _counts

#: bytes a launch moves per amplitude of the state, by kernel base name
BYTES_PER_AMPLITUDE = {
    "lane_factored_kernel": 16,
    "lane_kernel": 16,
    "row_gate_kernel": 16,
    "diag_kernel": 16,
    "hdh_multi_kernel": 16,
    "hdh_multi_uniform_kernel": 8,
}
#: ``hdh_multi_kernel<k, true>``: both planes read, the probability written
PROBS_FORM_BYTES = 12

#: a demangled kernel name's base name and template arguments, as the
#: trace gives them: ``(anonymous namespace)::diag_kernel(unsigned char
#: const*, ...)``, ``void (anonymous namespace)::hdh_multi_kernel<1,
#: false>(...)``
_KERNEL = re.compile(r"(\w+)(?:<([^()]*)>)?\(")


def bytes_per_amplitude(name: str) -> Optional[int]:
    """Bytes a launch of the kernel ``name`` moves per amplitude, or None
    for a kernel not in the table."""
    m = _KERNEL.search(name)
    if m is None or m.group(1) not in BYTES_PER_AMPLITUDE:
        return None
    if m.group(1) == "hdh_multi_kernel" and "true" in (
            a.strip() for a in (m.group(2) or "").split(",")):
        return PROBS_FORM_BYTES
    return BYTES_PER_AMPLITUDE[m.group(1)]


def read(run):
    t = run.trace
    if t is None:
        return None
    amplitudes = 1 << run.window.work["width"]
    nbytes = device_s = 0.0
    for name, _, seconds, _ in t.kernels:
        b = bytes_per_amplitude(name)
        if b is not None:
            nbytes += b * amplitudes
            device_s += seconds
    if not device_s:
        return None
    return _counts.roofline_percent(_counts.bound_seconds(nbytes=nbytes),
                                    device_s)
