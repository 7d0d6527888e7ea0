from .kernel import stacked_round_cuda  # noqa: F401
from .ops import on_card, put_rows, stacked_round, take_rows  # noqa: F401
from .ref import round_reference  # noqa: F401
