"""See the package docstring."""
