"""Host-side data: SDF reader and molecule templates, the ADW samples."""
