"""The public wrappers of the three kernels that port Pallas kernels, as
the reference's ``repro.kernels.ops`` exports them: each launches its
CUDA kernel on a CUDA tensor and takes the plain version on a CPU one.

The reference's wrappers fall back to the plain version on shapes that
do not divide their blocks; the port's take ragged lengths in the kernel
and raise on anything else.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.tat_lookup import tat_lookup

__all__ = ["flash_attention", "ssd_scan", "tat_lookup"]
