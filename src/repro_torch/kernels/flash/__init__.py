from .kernel import flash_attention_cuda, tensor_core_route  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import attention_reference  # noqa: F401
