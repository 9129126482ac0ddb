"""MSM engines: the cuZK pipeline, the classic Pippenger bucket method,
and the naive baseline."""

from ..ops.decompose import choose_chunk_size  # noqa: F401
from .cuzk import CuzkMsmEngine  # noqa: F401
from .naive import NaiveMsmEngine  # noqa: F401
from .pippenger import PippengerMsmEngine  # noqa: F401
