"""f32-leak fixture (torch): demotes an f64 product to f32 at line 8."""
import torch


def leak(x):
    # the demotion the dtype pass must flag
    y = x * 2.0
    return y.to(torch.float32)
