"""Host-side datasets of the port (numpy only)."""
