"""Parallel layouts of the port: the layout's degrees (``layout.py``),
the serving and training meshes and their collectives (``mesh.py``),
and a layout's ranks as processes (``launch.py``)."""
