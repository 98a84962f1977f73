"""Model side of the port (serving slice): layers, attention, the SSD
mixer, the decoder stack, and weight conversion from the reference's
layout.  Attention prefill runs the ``flash_attention`` kernel and SSD
prefill the ``ssd_scan`` kernel (``repro_torch.kernels``)."""
