"""Device context of the port."""
