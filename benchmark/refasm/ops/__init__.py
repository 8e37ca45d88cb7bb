"""The similarity product's host form (a frozen copy of the port's)."""
