"""Training-time losses of the port (``repro.training``'s OT part)."""
