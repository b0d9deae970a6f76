"""Entry points of the port: the serving step and the serving CLI."""
