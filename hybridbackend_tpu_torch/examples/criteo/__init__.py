"""The Criteo example of the port."""
