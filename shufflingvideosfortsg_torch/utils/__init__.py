"""Run management and weight interop of the port."""
