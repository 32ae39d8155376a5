"""Op definitions; importing this package registers every op."""
from . import registry
from . import math  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import output_ops  # noqa: F401
from . import optimizer_op  # noqa: F401
from . import pallas_ops  # noqa: F401
from . import quantization  # noqa: F401
from . import random_ops  # noqa: F401
from . import custom  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import la_op  # noqa: F401  (aliases every linalg_* op)
from . import numpy_ops  # noqa: F401

__all__ = ["registry"]
