"""Rule modules — importing each one registers its rules."""

from . import hygiene  # noqa: F401
from . import purity  # noqa: F401
from . import threads  # noqa: F401
from . import excepts  # noqa: F401
from . import caches  # noqa: F401
from . import dispatch  # noqa: F401
from . import drift  # noqa: F401
