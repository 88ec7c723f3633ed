"""Feature extraction and ranking towers of the port."""
