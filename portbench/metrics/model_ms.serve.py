"""The pipeline's model on one request's NDs, ms: CUDA events around the
benchmark's call of ``pipeline.model``, the median of 5 after one."""


def read(run):
    return None if run.stage_ms is None else run.stage_ms[1]
