"""qcmrf_tpu_torch — the PyTorch / CUDA port of :mod:`qcmrf_tpu`.

Mirrors ``qcmrf_tpu``'s module paths and public names, so each module's
counterpart is easy to find. Plain tensor code is PyTorch; the kernels of
the closed-form sampling path (``csrc/qcmrf_kernels.cu``) and of the
gate-level engine (``csrc/circuit_kernels.cu``, ``csrc/gate_kernels.cu``)
are hand-written CUDA C++
for Hopper, built with ``nvcc`` at their first use on a CUDA tensor and
bound with ``ctypes`` (:mod:`qcmrf_tpu_torch.ops._build`).

The package root exports the JAX package's 42 public names (and
``__version__``). Importing it builds nothing and imports neither ``jax``
nor ``qcmrf_tpu``. Start it with ``python -m qcmrf_tpu_torch run|eval``;
walkthroughs are in ``qcmrf_tpu_torch/examples/``.
"""

from qcmrf_tpu_torch.circuits.compiler import QCMRF, compile_qcmrf
from qcmrf_tpu_torch.circuits.ir import Circuit, Gate
from qcmrf_tpu_torch.circuits.lower import basis_gate_counts, lower
from qcmrf_tpu_torch.circuits.params import gamma_to_theta, theta_to_gamma
from qcmrf_tpu_torch.evaluation.estimators import (
    clique_marginals_exact,
    estimate_from_circuit,
    log_partition_from_counts,
)
from qcmrf_tpu_torch.evaluation.metrics import KL, extract_probs, fidelity, kl
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf, grid_mrf
from qcmrf_tpu_torch.models.suite import (GRAPHS, ModelSuite, generate_suite,
                                          load_suite)
from qcmrf_tpu_torch.models.elimination import (
    clique_marginals as elimination_marginals,
    log_partition as elimination_log_partition,
    marginal_map,
    sample_exact_elim,
)
from qcmrf_tpu_torch.models.ais import (
    ais_clique_marginals,
    ais_event_prob,
    ais_log_partition,
)
from qcmrf_tpu_torch.models.capability import explain as explain_capabilities
from qcmrf_tpu_torch.models.sample import (
    map_state_clamped,
    sample_conditional,
)
from qcmrf_tpu_torch.models.structure import (
    StructureFit,
    candidate_pairs,
    fit_structure,
    interaction_norms,
)
from qcmrf_tpu_torch.models.train import (fit_mle, fit_mle_sharded,
                                          fit_mle_shots)
from qcmrf_tpu_torch.noise.fit import (
    CalibratedNoiseModel,
    fit_calibrated,
    fit_noise_model,
)

__version__ = "0.1.0"

__all__ = [
    "QCMRF",
    "compile_qcmrf",
    "Circuit",
    "Gate",
    "MRF",
    "chain_mrf",
    "grid_mrf",
    "fidelity",
    "kl",
    "KL",
    "extract_probs",
    "theta_to_gamma",
    "gamma_to_theta",
    "GRAPHS",
    "ModelSuite",
    "generate_suite",
    "load_suite",
    "lower",
    "basis_gate_counts",
    "fit_mle",
    "fit_mle_sharded",
    "fit_mle_shots",
    "fit_structure",
    "candidate_pairs",
    "interaction_norms",
    "StructureFit",
    "estimate_from_circuit",
    "clique_marginals_exact",
    "log_partition_from_counts",
    "elimination_log_partition",
    "elimination_marginals",
    "marginal_map",
    "sample_exact_elim",
    "ais_log_partition",
    "ais_clique_marginals",
    "ais_event_prob",
    "explain_capabilities",
    "map_state_clamped",
    "sample_conditional",
    "CalibratedNoiseModel",
    "fit_calibrated",
    "fit_noise_model",
]
