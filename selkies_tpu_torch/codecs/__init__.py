"""Host-side H.264 bitstream pieces (numpy only)."""
