"""repro_torch.launch — the pod topology (``mesh.PodTopology``)."""
