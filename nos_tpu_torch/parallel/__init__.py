"""Parallel layouts of the port: the serving mesh (``mesh.py``)."""
