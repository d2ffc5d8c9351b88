"""Part of the frozen reference; see the package docstring."""
