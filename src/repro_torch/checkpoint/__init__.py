from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer, latest_step, restore, save,
)
