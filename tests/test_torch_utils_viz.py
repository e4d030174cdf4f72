"""The port's `viz.py` and `utils` against the reference's on the same
inputs (the mirror of `tests/test_viz_utils.py`): FeatureCollection
dicts and the fallback page's HTML text equal, the `%%mosaic_kepler`
magic's grammar and errors equal, and `MosaicContext.build` registering
the magic as the reference's does. The utilities run on the CPU here;
`tests/test_torch_kernels_gpu.py` holds `benchmark` and `device_trace`
on the card."""

import json
import logging

import numpy as np
import pytest
import torch

from mosaic_tpu import functions as RF
from mosaic_tpu import utils as RU
from mosaic_tpu import viz as RV
from mosaic_tpu.core.geometry import wkt as RW
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.readers.vector import VectorTable as RefTable
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch import functions as F
from mosaic_tpu_torch import utils as U
from mosaic_tpu_torch import viz
from mosaic_tpu_torch.context import MosaicContext
from mosaic_tpu_torch.core.geometry import wkt as W
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.readers.vector import VectorTable

GEOMS = [
    "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))",
    "POINT (2 2)",
    "LINESTRING (0 0, 3 1, 4 4)",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 2 4, 4 4, 4 2, 2 2))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5)))",
]
LON = np.array([-0.1, -0.2, -73.95, 139.7])
LAT = np.array([51.5, 51.6, 40.75, 35.68])


def _cells(res=7):
    got = F.grid_longlatascellid(LON, LAT, res, index=H3IndexSystem(), device="cpu")
    want = np.asarray(RF.grid_longlatascellid(LON, LAT, res, index=RefH3()))
    np.testing.assert_array_equal(np.asarray(got), want)
    return np.asarray(got)


def test_feature_collection_equals_the_reference():
    props = {"name": np.array(["a", "b", "c", "d", "e"], dtype=object),
             "v": np.arange(5, dtype=np.float64) / 3.0}
    got = viz.to_feature_collection(GEOMS, properties=props)
    want = RV.to_feature_collection(GEOMS, properties=props)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    assert got["features"][1]["geometry"]["type"] == "Point"
    assert got["features"][0]["properties"]["name"] == "a"


def test_feature_collection_of_a_packed_column_equals_the_reference():
    got = viz.to_feature_collection(W.from_wkt(GEOMS))
    want = RV.to_feature_collection(RW.from_wkt(GEOMS))
    assert got == want


def test_plot_cells_html_equals_the_reference(tmp_path):
    cells = _cells()
    out = viz.plot_cells(cells, index=H3IndexSystem(), values=[1.0, 2.0, 3.0, 4.0],
                         path=str(tmp_path / "port.html"))
    ref = RV.plot_cells(cells, index=RefH3(), values=[1.0, 2.0, 3.0, 4.0],
                        path=str(tmp_path / "ref.html"))
    assert out.endswith("port.html") and ref.endswith("ref.html")
    html = (tmp_path / "port.html").read_text()
    assert html == (tmp_path / "ref.html").read_text()
    assert "FeatureCollection" in html and "canvas" in html


@pytest.mark.parametrize("kind", ["geometry", "h3", "cells"])
def test_mosaic_kepler_dispatch_equals_the_reference(tmp_path, kind):
    if kind == "geometry":
        data, kw, rkw = GEOMS, {}, {}
    else:
        data, kw, rkw = _cells(), {"index": H3IndexSystem()}, {"index": RefH3()}
    got = viz.mosaic_kepler(data, kind=kind, path=str(tmp_path / "p.html"), **kw)
    want = RV.mosaic_kepler(data, kind=kind, path=str(tmp_path / "r.html"), **rkw)
    assert got.endswith("p.html") and want.endswith("r.html")
    assert (tmp_path / "p.html").read_text() == (tmp_path / "r.html").read_text()


def test_kepler_cell_magic_equals_the_reference(tmp_path, monkeypatch):
    """The `%%mosaic_kepler` grammar over a reader table, a dict and a
    bare column renders the reference's pages, and raises its errors."""
    monkeypatch.chdir(tmp_path)
    cells = _cells()
    ns = {"t": VectorTable(geometry=W.from_wkt(GEOMS[:2]), columns={"cell": cells[:2]}),
          "d": {"g": GEOMS}, "col": GEOMS[:3]}
    rns = {"t": RefTable(geometry=RW.from_wkt(GEOMS[:2]), columns={"cell": cells[:2]}),
           "d": {"g": GEOMS}, "col": GEOMS[:3]}
    for line in ("t geometry geometry", "t cell h3 1", "t cell CELLS 1", "d g geometry 2",
                 "col x geometry"):
        got = viz._magic_render(ns, line)
        page = (tmp_path / "mosaic_map.html").read_text()
        want = RV._magic_render(rns, line)
        assert str(got).endswith(".html") and str(want).endswith(".html")
        assert page == (tmp_path / "mosaic_map.html").read_text(), line
    for line, match in (("t geometry", "usage"), ("missing geometry geometry", "no variable"),
                        ("t cell hexes", "feature type")):
        with pytest.raises(ValueError, match=match) as got:
            viz._magic_render(ns, line)
        with pytest.raises(ValueError, match=match) as want:
            RV._magic_render(rns, line)
        assert str(got.value) == str(want.value)


def test_kepler_magic_registration(tmp_path, monkeypatch):
    """`register_kepler_magic` wires the cell magic into a live IPython
    shell, and `MosaicContext.build` registers it, as the reference's
    does (its `enable_mosaic`)."""
    pytest.importorskip("IPython")
    from IPython.core.interactiveshell import InteractiveShell

    monkeypatch.chdir(tmp_path)
    shell = InteractiveShell.instance()
    try:
        fn = viz.register_kepler_magic(shell)
        assert fn is not None and fn.__name__ == "mosaic_kepler"
        shell.user_ns["col"] = ["POINT (1 1)"]
        out = shell.run_cell_magic("mosaic_kepler", "col x", "geometry")
        assert str(out).endswith(".html")
        del shell.magics_manager.magics["cell"]["mosaic_kepler"]
        MosaicContext.build("H3")
        assert "mosaic_kepler" in shell.magics_manager.magics["cell"]
        out = shell.run_cell_magic("mosaic_kepler", "col x", "geometry")
        assert str(out).endswith(".html")
    finally:
        MosaicContext.reset()
        InteractiveShell.clear_instance()


def test_register_kepler_magic_outside_ipython_is_none():
    assert viz.register_kepler_magic() is None
    assert RV.register_kepler_magic() is None


def test_timer_and_benchmark_match_the_reference(caplog):
    with caplog.at_level(logging.INFO, logger="mosaic_tpu_torch"):
        with U.timer("unit") as t:
            sum(range(1000))
    assert t["seconds"] >= 0 and t["label"] == "unit"
    assert any("unit:" in r.getMessage() for r in caplog.records)
    got = U.benchmark(lambda x: torch.sum(x * 2), torch.arange(1000.0), trials=3)
    want = RU.benchmark(lambda x: x.sum() * 2, np.arange(1000.0), trials=3)
    assert set(got) == set(want) == {"trials", "min_s", "median_s", "mean_s"}
    assert got["trials"] == 3 and got["min_s"] <= got["median_s"]
    assert U.get_logger().name == "mosaic_tpu_torch"
    assert U.get_logger() is U.get_logger()
    assert U.__all__ == RU.__all__


def test_benchmark_walks_results_and_syncs_their_cuda_devices(monkeypatch):
    """The result walk reaches tensors in tuples, lists, dicts,
    dataclasses and ``.metrics`` holders, and each trial synchronises the
    CUDA device of every one it finds (a tensor that reports a CUDA
    device stands in for the card here); CPU tensors need no wait. The
    card's own wait is a gpu test."""
    import dataclasses

    @dataclasses.dataclass
    class Box:
        t: object

    class Holder:
        def __init__(self, t):
            self.metrics = {"t": t}

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return torch.device("cuda", 1)

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    card, host = torch.ones(3).as_subclass(OnCard), torch.ones(3)
    for wrap in (lambda t: t, lambda t: (1, t), lambda t: [{"a": [t]}], Box, Holder):
        calls.clear()
        U.benchmark(lambda: wrap(host), trials=2, warmup=1)
        assert calls == []
        U.benchmark(lambda: wrap(card), trials=2, warmup=1)
        assert calls == [torch.device("cuda", 1)] * 3
    for r in (None, "text", 3.0, np.ones(2)):
        assert U._cuda_devices(r, set()) == set()


def test_device_trace_exports_a_chrome_trace_on_the_cpu(tmp_path):
    with U.device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        with U.annotate("mosaic.unit_region"):
            torch.ones(64).sum()
    assert prof.trace_path.startswith(str(tmp_path / "tr"))
    with open(prof.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "mosaic.unit_region" in names


def test_device_trace_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default traces it")
    with pytest.raises(DeviceUnavailable):
        with U.device_trace("unused"):
            pass
