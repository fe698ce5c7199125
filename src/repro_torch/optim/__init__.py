from repro_torch.optim.optimizer import (  # noqa: F401
    OptimizerConfig, init_opt_state, apply_updates, schedule_lr,
    global_norm, clip_by_global_norm,
)
