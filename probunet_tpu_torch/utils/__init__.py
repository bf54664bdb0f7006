"""Host-side utilities: figures."""
