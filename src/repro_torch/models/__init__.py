from .lm import DecoderLM, EncDecLM, HybridLM, Model, XLSTMLM, build_model  # noqa: F401
from .module import ParamTree, param_count  # noqa: F401
