from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
)
from repro_torch.train.trainer import (  # noqa: F401
    TrainHParams,
    init_train_state,
    lm_loss,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    policy_loss,
)
