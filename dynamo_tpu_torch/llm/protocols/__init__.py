"""Wire protocols: the internal backend IO types."""
