"""The flat function namespace of the port — ``from
mosaic_tpu_torch.functions import *`` is the analog of ``import
mosaicContext.functions._`` (port of ``mosaic_tpu/functions``, the
reference's names in its ``__all__`` order).

The ST_ measures and predicates, :func:`grid_longlatascellid` and the
``rst_rastertogrid*`` projections run on the device (the card unless the
caller passes ``device="cpu"``); the codecs, host geometry engines and
the rest of the grid and raster functions are host numpy, as in the
reference.
"""

from .aggregates import *  # noqa: F401,F403
from .formats import *  # noqa: F401,F403
from .geometry import *  # noqa: F401,F403
from .grid import *  # noqa: F401,F403
from .raster import *  # noqa: F401,F403
from .util import *  # noqa: F401,F403

from . import aggregates, formats, geometry, grid, raster, util

__all__ = (
    list(geometry.__all__)
    + list(grid.__all__)
    + list(formats.__all__)
    + list(aggregates.__all__)
    + list(raster.__all__)
    + list(util.__all__)
)
