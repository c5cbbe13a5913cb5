"""The pipeline's NDT preprocessing of one request's batch, ms: CUDA
events around the benchmark's call of ``ndt_preprocessing_with_state``
with the pipeline's arguments, the median of 5 after one."""


def read(run):
    return None if run.stage_ms is None else run.stage_ms[0]
