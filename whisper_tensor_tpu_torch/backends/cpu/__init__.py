"""Host (numpy) code of the port's packed weights."""
