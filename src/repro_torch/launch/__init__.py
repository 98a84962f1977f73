"""Launchers of the port: ``serve`` (batched prefill + greedy decode)."""
