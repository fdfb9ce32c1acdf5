"""Synthetic data for the port: LM token streams and domain-adaptation pairs."""
