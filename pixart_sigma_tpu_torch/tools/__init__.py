"""Command-line tools of the port, run as modules (python -m ...)."""
