"""The optimizer (port of ``repro.optim``): AdamW and top-k gradient
compression on trees of tensors."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)
from repro_torch.optim.compress import topk_compress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "topk_compress_grads"]
