from .kernel import matmul_cuda  # noqa: F401
from .ops import matmul, tiles_exactly  # noqa: F401
from .ref import matmul_reference  # noqa: F401
