"""Steps of the port."""
