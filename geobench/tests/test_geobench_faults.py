"""The comparison that decides ``correct`` sees each fault a cell can
have. A tiny cell runs on the CPU (the look for a card skipped), with the
timed path broken underneath, and ``correct`` comes out false:

- a step that returns its state unchanged: the stream's fold does not
  move;
- half of a batch left out: the second half of each batch answered -1;
- an answer altered where it is produced: every match moved to the next
  polygon id.

The exchange between chips does not exist in these one-chip cells.
"""

import json

import pytest
import torch

import mosaic_tpu_torch.sql.join as J
import mosaic_tpu_torch.sql.stream as S


def half_left_out(real):
    def join(points, *a, **kw):
        out = real(points, *a, **kw)
        n = points.shape[0]
        out = out.clone()
        out[n // 2:] = -1
        return out
    return join


def altered(real):
    def join(points, *a, **kw):
        out = real(points, *a, **kw)
        return torch.where(out >= 0, out + 1, out)
    return join


def unchanged_fold(out):
    return torch.zeros(3, dtype=torch.int64, device=out.device)


def verdict(run_tiny, workload):
    code, out, _ = run_tiny(workload)
    assert code == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", ["tiny_zones.tiny_stream", "tiny_zones.tiny_curbside"])
def test_sound_stream_is_correct(run_tiny, workload):
    assert verdict(run_tiny, workload)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged_state", "half_left_out", "altered_answer"])
@pytest.mark.parametrize("workload", ["tiny_zones.tiny_stream", "tiny_zones.tiny_curbside"])
def test_stream_fault_is_caught(run_tiny, monkeypatch, workload, fault):
    if fault == "unchanged_state":
        monkeypatch.setattr(S, "_fold_terms", unchanged_fold)
    else:
        wrap = half_left_out if fault == "half_left_out" else altered
        monkeypatch.setattr(S, "pip_join_points", wrap(S.pip_join_points))
    assert verdict(run_tiny, workload)["correct"] is False


@pytest.mark.parametrize("fault", [None, "half_left_out", "altered_answer"])
def test_batch_fault_is_caught(run_tiny, monkeypatch, fault):
    if fault is not None:
        wrap = half_left_out if fault == "half_left_out" else altered
        monkeypatch.setattr(J, "pip_join_points", wrap(J.pip_join_points))
    assert verdict(run_tiny, "tiny_zones.tiny_batch")["correct"] is (fault is None)
