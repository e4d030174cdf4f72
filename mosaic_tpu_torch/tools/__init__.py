"""Tools of the port: the epsilon-band calibration sweep, the CPU
first-call sweep, the card priors, and the ops plane's trail tools
(``trace_report``, ``stall_report``, ``perf_gate``, ``fleet_report``,
``doctor``), each run as ``python -m mosaic_tpu_torch.tools.<name>``."""
