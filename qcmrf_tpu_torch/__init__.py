"""qcmrf_tpu_torch — the PyTorch / CUDA port of :mod:`qcmrf_tpu`.

Mirrors ``qcmrf_tpu``'s module paths and public names, so each module's
counterpart is easy to find. Plain tensor code is PyTorch; the kernels of
the closed-form sampling path (``csrc/qcmrf_kernels.cu``) and of the
gate-level engine (``csrc/circuit_kernels.cu``, ``csrc/gate_kernels.cu``)
are hand-written CUDA C++
for Hopper, built with ``nvcc`` at their first use on a CUDA tensor and
bound with ``ctypes`` (:mod:`qcmrf_tpu_torch.ops._build`).

Importing this package builds nothing and imports neither ``jax`` nor
``qcmrf_tpu``. Start it with ``python -m qcmrf_tpu_torch run|eval``.
"""

from qcmrf_tpu_torch.circuits.compiler import QCMRF, compile_qcmrf
from qcmrf_tpu_torch.circuits.lower import basis_gate_counts, lower

__all__ = ["QCMRF", "compile_qcmrf", "lower", "basis_gate_counts"]
