"""Launchers of the port: ``serve`` (batched prefill + greedy decode of a
zoo model on one device) and ``mesh`` (the production and test meshes over
the ranks of ``torch.distributed``)."""
