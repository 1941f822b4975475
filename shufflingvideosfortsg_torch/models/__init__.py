"""Models of the port: GMD and its components."""
