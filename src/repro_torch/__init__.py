"""PyTorch + CUDA port of the Persistent CXL Switch reproduction.

A second package beside the JAX reference ``repro``; it imports
``torch``, numpy and the standard library, never JAX or ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
