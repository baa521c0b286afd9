from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, global_grad_norm)
from repro_torch.optim.compression import quantize_int8_axiswise
from repro_torch.optim.schedule import cosine_schedule, linear_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_grad_norm", "quantize_int8_axiswise", "cosine_schedule",
           "linear_schedule"]
