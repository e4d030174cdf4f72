"""The port's repository tools: the API reference, the R bindings and the
coverage gate (`mosaic_tpu_torch/tools/`)."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

from mosaic_tpu_torch.context import MosaicContext
from mosaic_tpu_torch.tools import coverage_gate, generate_api_docs, generate_r_bindings

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


@pytest.fixture
def registered():
    names = set(MosaicContext.build("H3").register())
    yield names
    MosaicContext.reset()


def test_api_doc_is_current(registered):
    want = generate_api_docs.generate()
    got = (ROOT / "docs" / "TORCH_API.md").read_text()
    assert got == want, (
        "docs/TORCH_API.md is stale - run: python -m mosaic_tpu_torch.tools.generate_api_docs"
    )


def test_api_doc_lists_every_registered_name(registered):
    doc = (ROOT / "docs" / "TORCH_API.md").read_text()
    listed = set(re.findall(r"^\| `([A-Za-z_0-9]+)\(", doc, re.M))
    assert registered <= listed
    assert "mosaic_tpu_torch" in doc.splitlines()[2]
    assert not re.search(r"\b(TPU|ms|points/s|GB/s)\b", doc.split("## Observability")[0])


def test_r_bindings_generated_and_complete(registered):
    path = ROOT / "R" / "mosaicTpuTorch" / "R" / "functions.R"
    assert path.exists(), "run: python -m mosaic_tpu_torch.tools.generate_r_bindings"
    src = path.read_text()
    exported = set(re.findall(r"^([A-Za-z_0-9]+) <- function", src, re.M))
    missing = registered - exported
    assert not missing, f"R bindings missing: {sorted(missing)}"
    stale = exported - registered - {"enableMosaic"}
    assert not stale, f"stale R bindings for removed names: {sorted(stale)}"
    assert 'reticulate::import("mosaic_tpu_torch")' in src


def test_r_package_is_current(registered):
    for rel, text in generate_r_bindings.generate().items():
        assert (ROOT / "R" / "mosaicTpuTorch" / rel).read_text() == text, rel


@pytest.mark.parametrize("rel", [
    "mosaic_tpu_torch/runtime/retry.py",
    "mosaic_tpu_torch/models/core.py",
    "mosaic_tpu_torch/sql/overlay.py",
    "mosaic_tpu/runtime/retry.py",
])
def test_executable_lines_equal_the_reference_tools(rel):
    import coverage_gate as ref_gate

    path = str(ROOT / rel)
    assert coverage_gate.executable_lines(path) == ref_gate.executable_lines(path)
    assert coverage_gate.executable_lines(path)


def test_main_over_one_small_test_file(tmp_path):
    test = tmp_path / "test_small.py"
    test.write_text(
        "def test_small():\n"
        "    from mosaic_tpu_torch.models import CheckpointManager\n"
        "    assert CheckpointManager.__name__ == 'CheckpointManager'\n"
    )
    out = subprocess.run(
        [sys.executable, "-m", "mosaic_tpu_torch.tools.coverage_gate",
         "--fail-under", "0", str(test), "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    m = re.search(r"coverage-gate: ([0-9.]+)% of ([0-9]+) executable lines", out.stdout)
    assert m and 0.0 < float(m.group(1)) < 100.0 and int(m.group(2)) > 10_000
    assert "mosaic_tpu_torch/" in out.stdout and "coverage-gate: OK" in out.stdout
