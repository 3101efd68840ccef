"""Serving steps of the port (see ``serve.step``)."""
