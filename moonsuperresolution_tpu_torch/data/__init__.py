"""Host-side training data of the port."""
