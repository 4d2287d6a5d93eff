"""Data pipelines of the port (``repro.data``)."""
