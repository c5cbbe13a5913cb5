"""The Dense -> BatchNorm (-> ReLU) epilogue's launches a request
(``ndtpu_torch/ops/epilogue.py``, kernel ``dense_bn_act_kernel``): its
kernels in the device trace over the traced requests (the host's
``ndtpu.request`` events). None where no such kernel ran."""

KERNEL = "dense_bn_act_kernel"


def read(run):
    if run.trace is None:
        return None
    launches, _ = run.trace.kernel(KERNEL)
    requests = sum(n == "ndtpu.request" for n, _, _ in run.trace.host)
    if not launches or not requests:
        return None
    return launches / requests
