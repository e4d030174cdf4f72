"""Tools of the port: the epsilon-band calibration sweep, the CPU
first-call sweep, the card priors, the ops plane's trail tools
(``trace_report``, ``stall_report``, ``perf_gate``, ``fleet_report``,
``doctor``), the linter (``lint``), the fault sweep (``chaos_sweep``)
and the repository tools (``generate_api_docs``, ``generate_r_bindings``,
``coverage_gate``), each run as ``python -m mosaic_tpu_torch.tools.<name>``."""
