"""Drivers of a traffic file's ``kind``: each exposes ``run(ctx)``."""
