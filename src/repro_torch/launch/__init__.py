"""Launchers of the port: ``serve`` (batched prefill + greedy decode of a
zoo model on one device)."""
