"""The deterministic synthetic data pipeline (the counterpart of the
reference's ``data/``)."""
