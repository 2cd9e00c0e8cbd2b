"""Host utilities of the serving path: native host ops and PLY output."""
