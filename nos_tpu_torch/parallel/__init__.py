"""Parallel layouts of the port: the layout's degrees (``layout.py``),
the serving and training meshes and their collectives (``mesh.py``),
a layout's ranks as processes (``launch.py``), and the pipeline
schedules over the training mesh's pp axis (``pipeline.py``)."""
