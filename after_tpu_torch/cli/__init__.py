"""Command-line pieces of the port."""
