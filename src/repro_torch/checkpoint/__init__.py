"""Async, integrity-checked checkpoints in the reference's format (the
counterpart of the reference's ``checkpoint/``)."""
