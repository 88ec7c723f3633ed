"""Train steps of the port."""
