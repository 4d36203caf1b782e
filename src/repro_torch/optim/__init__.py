from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    chain_clip,
    clip_by_global_norm,
    masked,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)
