"""Serving LM of the port: config, layers, decode path (``model``)."""
