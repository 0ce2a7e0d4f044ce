"""Models of the port's simulation tier (the Table-6 CNN)."""
