"""Carry state across from the JAX package.

The port and the reference agree field for field on the join index; this
module builds the port's :class:`~mosaic_tpu_torch.sql.join.ChipIndex`
from the reference's arrays, so both packages can run on one index. It
takes plain numpy arrays and never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .sql.join import ChipIndex


def chip_index_from_reference(arrays: dict[str, np.ndarray], device=None) -> ChipIndex:
    """The port's ChipIndex from a reference ChipIndex's fields as numpy.

    ``arrays`` maps each field name of ``mosaic_tpu.sql.join.ChipIndex``
    to its array (uint32 slot bits and the uint64 hash multiplier as the
    reference stores them), ``border.<field>`` to the fields of its
    ``border`` geometry, and optionally the ``hr_*`` keys of the host
    companion's ``save_arrays()``, which become ``.host``. ``device``
    defaults to the card. :meth:`ChipIndex.to_arrays` is the inverse.
    """
    return ChipIndex.from_arrays(arrays, device=device)
