"""Device library, netlists, thermal solver and the Algorithm 1/2 entry
points of the PyTorch port."""
