"""Step builders of the port's runtime (serving; training comes later)."""
