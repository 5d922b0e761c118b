"""Command-line entry points of the port: ``train`` and ``test``."""
