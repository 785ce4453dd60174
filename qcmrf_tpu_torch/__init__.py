"""qcmrf_tpu_torch — the PyTorch / CUDA port of :mod:`qcmrf_tpu`.

Mirrors ``qcmrf_tpu``'s module paths and public names, so each module's
counterpart is easy to find. Plain tensor code is PyTorch; the kernels of
the closed-form sampling path are hand-written CUDA C++ for Hopper
(``csrc/qcmrf_kernels.cu``), built with ``nvcc`` at their first use on a
CUDA tensor and bound with ``ctypes`` (:mod:`qcmrf_tpu_torch.ops._build`).

Importing this package builds nothing and imports neither ``jax`` nor
``qcmrf_tpu``. Start it with ``python -m qcmrf_tpu_torch run|eval``.
"""
