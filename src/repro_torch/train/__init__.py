"""Training: AdamW, the microbatched train step, the data-parallel step
through PCCL's planned all-reduce and the fault-tolerant ``Trainer``
(``repro.train`` and the gradient path of ``examples/pccl_dp_training.py``)."""
from .data_parallel import dp_gradients, make_dp_train_step  # noqa: F401
from .optimizer import (  # noqa: F401
    OptimizerConfig,
    OptState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    learning_rate,
)
from .train_step import (  # noqa: F401
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from .trainer import Trainer, TrainerConfig  # noqa: F401
