"""Host-side molecule data: SDF reader and molecule templates."""
