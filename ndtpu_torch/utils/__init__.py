"""Small helpers of the port (port of ``ndtpu/utils``).

- ``device.py``: ``resolve_device``, the counterpart of
  ``ndtpu/utils/platform.py::is_tpu``. The JAX package asks the backend
  whether it compiles for the TPU to pick the Pallas kernel or its
  interpreted form; the port needs no such question, because the tensors'
  device picks the route: a kernel wrapper launches its CUDA kernel on a
  card's tensors and runs its plain version on the CPU's. The tools'
  ``--use_pallas`` / ``--no_pallas`` flags are kept on the command line
  and refused, as ``train/config.py`` refuses any ``--use_pallas`` but
  ``auto``.
- ``logging.py``: ``get_logger`` and the reference's ``print_matrix``.
- ``profiling.py``: ``profile_trace`` (torch.profiler) and ``timed``.
- ``ndtpu/utils/hlo.py`` has its counterpart in
  ``parallel/collectives.py`` (the collectives counter).
"""
