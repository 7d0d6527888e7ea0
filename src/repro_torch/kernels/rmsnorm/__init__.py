from .kernel import rmsnorm_triton  # noqa: F401
from .ops import rmsnorm  # noqa: F401
from .ref import rmsnorm_reference  # noqa: F401
