"""The card's accuracy check of the dense lane pass can tell float32
accuracy from one TF32 pass. ``lane_kernel`` (csrc/gate_kernels.cu) takes
each product on the tensor cores as three TF32 products of split
operands (3xTF32); this file emulates that arithmetic and one TF32 pass
in torch on the CPU (operands rounded to TF32 by round-to-nearest, ties
away, as the kernel's ``tf32_rna``; products and sums in float32) and
holds both to the criterion ``ops.kernels.lane_accurate`` applies on
the card: a relative 2-norm error against the float64 product of at most
2e-6 and at most 4x float32 ``torch.matmul``'s on the same input. The
lane ops are the JAX planner's for lowered QCMRF circuits, and a random
M."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.circuits.lower import lower as jlower  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.sim import tpu as jtpu  # noqa: E402

from qcmrf_tpu_torch.ops import kernels  # noqa: E402

ROWS = 1 << 12


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away: half a
    TF32 ulp added to the magnitude's bits, the 13 low bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def products(X, W):
    """(float32, 3xTF32, one TF32 pass) of the stacked planes X (rows,
    256) and the lane op's real form W (256, 256)."""
    xh, wh = tf32_rna(X), tf32_rna(W)
    xl, wl = tf32_rna(X - xh), tf32_rna(W - wh)
    return X @ W, (xl @ wh + xh @ wl) + xh @ wh, xh @ wh


def jax_lane_ops():
    """The distinct ``M`` of the JAX planner's lane ops for two lowered
    QCMRF circuits (a chain and 3-variable cliques, both styles)."""
    found = {}
    for cliques, style in (([[0, 1], [1, 2], [2, 3], [3, 4]], "fused"),
                           ([[0, 1, 2], [2, 3, 4]], "literal")):
        dim = sum(1 << len(C) for C in cliques)
        theta = -np.abs(np.random.RandomState(5).randn(dim)) * 0.5
        jc = jlower(jcompile(JMRF.create(cliques, theta=theta)), style=style)
        for op in jtpu.fuse_ops(jc):
            if op[0] == "lane":
                M = np.asarray(op[1], np.complex64)
                found.setdefault(M.tobytes(), M)
    return list(found.values())


def errors(M, seed=0):
    rng = np.random.RandomState(seed)
    re = torch.from_numpy(rng.randn(ROWS, 128).astype(np.float32))
    im = torch.from_numpy(rng.randn(ROWS, 128).astype(np.float32))
    scale = float(torch.cat([re, im]).double().norm())
    planes = (re / scale, im / scale)
    X = torch.cat(planes, 1)
    W = kernels.lane_stacked_w(M, "cpu")
    return [kernels.lane_relative_error(M, planes, Y)
            for Y in products(X, W)]


def test_tf32_rounding():
    """To nearest with ties away from zero, 13 low bits cleared."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 - 2 ** -23,
                      -(1.0 + 2 ** -11), 3.0e-39], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    assert tf32_rna(x)[:4].tolist() == want
    assert (tf32_rna(x).view(torch.int32) & 8191).eq(0).all()


@pytest.mark.parametrize("case", ["jax planner", "random"])
def test_check_passes_3xtf32_and_fails_one_pass(case):
    """3xTF32 meets the card's criterion on every lane op; one TF32 pass
    (about 2e-4 off) fails it on every one. Where float32 itself is exact
    (a lane op of one unit entry a row: a permutation with signs), the
    factor test cannot hold, and the 2e-6 limit alone decides."""
    if case == "random":
        rng = np.random.RandomState(24)
        ops = [((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16
                ).astype(np.complex64)]
    else:
        ops = jax_lane_ops()
        assert len(ops) >= 3
    for M in ops:
        f32, three, one = errors(M)
        assert three <= kernels.LANE_REL_LIMIT, three
        assert one > kernels.LANE_REL_LIMIT, one
        if f32 > 0:
            assert kernels.lane_accurate(three, f32), (three, f32)
            assert not kernels.lane_accurate(one, f32), (one, f32)
