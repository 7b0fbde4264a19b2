"""Step builders of the port (``repro.launch`` counterparts)."""
