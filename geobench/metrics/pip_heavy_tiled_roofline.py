"""Kernels: ``pip_heavy_tiled``'s share of its roofline, in percent. The
time is the profiler's device time of every kernel the wrapper launches
in the profiled window; the bound is the larger of the bytes over the
memory rate and the f32 operations over the f32 rate, for the work the
harness counted for the same launches (``roofline.heavy_work``). Nothing
is returned where the kernel did not launch, or where the launches and
the counted batches disagree."""

from geobench import roofline


def read(trace):
    frags = roofline.KERNEL_OPS["pip_heavy_tiled"]
    sec, launches = trace.kernel_seconds(frags)
    work = trace.work.get("pip_heavy_tiled")
    if not launches or not work or work["launches"] != launches or sec <= 0:
        return None
    t, _ = roofline.bound_s(work["bytes"], work["ops"])
    return 100.0 * t / sec
