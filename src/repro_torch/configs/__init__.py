"""Architecture configs: plain dataclasses, copied from the reference's
``configs/`` so that the port imports nothing of it."""
