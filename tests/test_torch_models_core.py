"""The model skeletons: `CheckpointManager`, `IterativeTransformer` and
`BinaryTransformer`, the port beside the reference.

The reference's three tests (`tests/test_models_services.py`) run on both
packages side by side, and the checkpoint part files each writes must be
the same, array for array (same names, dtypes, shapes and values)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from mosaic_tpu.models import BinaryTransformer as RefBinary
from mosaic_tpu.models import CheckpointManager as RefCheckpoint
from mosaic_tpu.models import IterativeTransformer as RefIterative
from mosaic_tpu_torch.models import (
    BinaryTransformer,
    CheckpointManager,
    IterativeTransformer,
)

SIDES = {
    "port": (CheckpointManager, IterativeTransformer, BinaryTransformer),
    "reference": (RefCheckpoint, RefIterative, RefBinary),
}


def _parts(directory: Path) -> list[dict[str, np.ndarray]]:
    return [dict(np.load(p, allow_pickle=True)) for p in sorted(directory.glob("part-*.npz"))]


def assert_same_parts(got_dir: Path, want_dir: Path) -> None:
    got, want = _parts(got_dir), _parts(want_dir)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_manager(tmp_path, side):
    CM = SIDES[side][0]
    ck = CM(str(tmp_path / "ck"))
    ck.append({"a": np.arange(3), "b": np.ones(3)})
    assert ck.load()["a"].tolist() == [0, 1, 2]
    ck.append({"a": np.arange(3, 5), "b": np.zeros(2)})
    assert ck.load()["a"].tolist() == [0, 1, 2, 3, 4]
    ck.overwrite({"a": np.array([9]), "b": np.array([9.0])})
    assert ck.load()["a"].tolist() == [9]
    assert [p.name for p in (tmp_path / "ck").glob("part-*.npz")] == ["part-00000.npz"]
    ck.write_meta({"k": 5})
    assert ck.read_meta()["k"] == 5
    ck.delete()
    assert not (tmp_path / "ck").exists()
    ck.delete()  # a second delete is a no-op


def test_checkpoint_files_equal_the_references(tmp_path):
    tables = [
        {"a": np.arange(3), "b": np.ones(3)},
        {"a": np.arange(3, 5), "b": np.zeros(2)},
    ]
    for name, CM in (("port", CheckpointManager), ("ref", RefCheckpoint)):
        ck = CM(str(tmp_path / name))
        for t in tables:
            ck.append(t)
    assert_same_parts(tmp_path / "port", tmp_path / "ref")
    CheckpointManager(str(tmp_path / "port")).overwrite({"a": np.array([9])})
    RefCheckpoint(str(tmp_path / "ref")).overwrite({"a": np.array([9])})
    assert_same_parts(tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_iterative_transformer(side):
    IT = SIDES[side][1]
    steps = []

    def step(state, i):
        steps.append(i)
        return state + i

    it = IT(step, should_stop=lambda prev, cur: cur >= 6, max_iterations=10)
    assert it.iterations_run == 0
    out = it.iterate(0)
    assert out == 6  # 0+1+2+3
    assert it.iterations_run == 3
    assert steps == [1, 2, 3]


@pytest.mark.parametrize("max_iterations", [1, 2, 5])
def test_iterative_transformer_runs_out_as_the_reference(max_iterations):
    runs = []
    for IT in (IterativeTransformer, RefIterative):
        it = IT(lambda s, i: s * 2 + i, should_stop=lambda p, c: False,
                max_iterations=max_iterations)
        runs.append((it.iterate(1), it.iterations_run))
    assert runs[0] == runs[1] == (runs[1][0], max_iterations)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_binary_transformer_threads_right_side(tmp_path, side):
    CM, _, BT = SIDES[side]
    right = np.asarray([1.0, 2.0, 3.0])
    seen = []

    def join_step(left, r, i):
        seen.append(r)
        return left + r.sum()  # each iteration folds the right side in

    ck = CM(str(tmp_path / "bt"))
    bt = BT(join_step, should_stop=lambda prev, cur: cur >= 18,
            max_iterations=10, right=right, checkpoint=ck)
    out = bt.transform(0.0)
    assert out == 18.0 and bt.iterations_run == 3
    assert all(r is right for r in seen)
    loaded = ck.load()
    assert loaded["iteration"].tolist() == [1, 2, 3]
    assert loaded["left"].tolist() == [6.0, 12.0, 18.0]


def _binary_parts(tmp_path, name, BT, CM, join_step, left0, n=3):
    ck = CM(str(tmp_path / name))
    bt = BT(join_step, should_stop=lambda p, c: False, max_iterations=n,
            right=None, checkpoint=ck)
    return bt.transform(left0), tmp_path / name


def test_binary_transformer_checkpoints_a_scalar_state_as_the_reference(tmp_path):
    """A 0-d state is checkpointed as a one-element ``left`` column."""
    port_out, port_dir = _binary_parts(
        tmp_path, "port", BinaryTransformer, CheckpointManager,
        lambda s, r, i: s + torch.tensor(float(i), dtype=torch.float64),
        torch.tensor(0.5, dtype=torch.float64),
    )
    ref_out, ref_dir = _binary_parts(
        tmp_path, "ref", RefBinary, RefCheckpoint,
        lambda s, r, i: s + np.float64(i), np.float64(0.5),
    )
    assert float(port_out) == float(ref_out) == 6.5
    assert_same_parts(port_dir, ref_dir)
    assert CheckpointManager(str(port_dir)).load()["left"].tolist() == [1.5, 3.5, 6.5]


def test_binary_transformer_checkpoints_a_tensor_dict_as_the_reference(tmp_path):
    """A dict of tensors is checkpointed column by column, each copied to
    the host, and an ``iteration`` key of the state is replaced by the
    step's own; the parts equal the reference's on the same numpy
    state."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 16, size=200)
    w = rng.random(200)

    def port_step(s, r, i):
        t = torch.as_tensor(ids)
        return {
            "counts": s["counts"] + torch.bincount(t + 1, minlength=17),
            "sum": s["sum"] + torch.as_tensor(w).sum() * i,
            "iteration": torch.tensor(-1),
        }

    def ref_step(s, r, i):
        return {
            "counts": s["counts"] + np.bincount(ids + 1, minlength=17),
            "sum": s["sum"] + w.sum() * i,
            "iteration": np.asarray(-1),
        }

    port_out, port_dir = _binary_parts(
        tmp_path, "port", BinaryTransformer, CheckpointManager, port_step,
        {"counts": torch.zeros(17, dtype=torch.int64),
         "sum": torch.tensor(0.0, dtype=torch.float64)},
        n=4,
    )
    ref_out, ref_dir = _binary_parts(
        tmp_path, "ref", RefBinary, RefCheckpoint, ref_step,
        {"counts": np.zeros(17, dtype=np.int64), "sum": np.float64(0.0)},
        n=4,
    )
    assert port_out["counts"].numpy().tolist() == ref_out["counts"].tolist()
    assert_same_parts(port_dir, ref_dir)
    loaded = CheckpointManager(str(port_dir)).load()
    assert loaded["iteration"].tolist() == [1, 2, 3, 4]
    assert loaded["counts"].shape == (4 * 17,)


@pytest.mark.parametrize("bad", ["ragged", "bfloat16"])
def test_unconvertible_state_raises_type_error(tmp_path, bad):
    """A state that is not array-convertible raises the reference's
    ``TypeError`` naming the column, rather than dropping it."""
    state = (
        [[1.0], [1.0, 2.0]] if bad == "ragged"
        else torch.ones(3, dtype=torch.bfloat16)
    )
    ck = CheckpointManager(str(tmp_path / "bad"))
    bt = BinaryTransformer(lambda s, r, i: {"x": state}, should_stop=lambda p, c: False,
                           max_iterations=1, checkpoint=ck)
    with pytest.raises(TypeError, match="checkpointed state 'x' is not array-convertible"):
        bt.transform(None)
    if bad == "ragged":
        ref = RefBinary(lambda s, r, i: {"x": state}, should_stop=lambda p, c: False,
                        max_iterations=1, checkpoint=RefCheckpoint(str(tmp_path / "ref")))
        with pytest.raises(TypeError, match="checkpointed state 'x' is not array-convertible"):
            ref.transform(None)
