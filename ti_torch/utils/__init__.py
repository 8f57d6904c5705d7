"""Host-side utilities: metric logging."""
