"""Getting the split sweeps' plans a query (``plan_ms.query``), in ms:
the self time of the program's ``qcmrf.kernels.plan`` spans (a plan built
or found in its cache, and its tables on the device)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name == "qcmrf.kernels.plan"))
