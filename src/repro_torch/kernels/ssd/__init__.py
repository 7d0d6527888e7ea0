from .kernel import ssd_cuda, ssd_route, tensor_core_route  # noqa: F401
from .ops import ssd  # noqa: F401
from .ref import ssd_decode_step, ssd_reference  # noqa: F401
