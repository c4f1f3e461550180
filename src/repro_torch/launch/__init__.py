"""Device placement for the port's sharded index (``launch/mesh.py``)."""
