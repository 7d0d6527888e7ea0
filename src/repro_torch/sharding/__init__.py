from . import rules
from .partition import (
    SITES,
    Rules,
    Sharding,
    active_mesh,
    active_rules,
    default_rules,
    param_sharding,
    placed,
    placements,
    shard,
    spec_for,
    use_partitioning,
)

# the port's DTensor rules where the running torch has none (``rules``)
RULES_INSTALLED = rules.install()

__all__ = [k for k in dir() if not k.startswith("_")]
