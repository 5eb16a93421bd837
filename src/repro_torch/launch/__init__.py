"""Entry points of the port: ``serve`` (the elastic serving loop)."""
