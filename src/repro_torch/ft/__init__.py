"""repro_torch.ft — fault tolerance of the port: heartbeats, the straggler
detector and the retry wrapper (``monitor``), and the control plane's
elastic work migration (``elastic``)."""
