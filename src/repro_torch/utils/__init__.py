"""Host-side utilities: fault injection for chaos runs, logging."""
