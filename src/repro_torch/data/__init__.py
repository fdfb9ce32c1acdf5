"""Synthetic data for the port (domain-adaptation pairs)."""
