"""Sharding of an analysis over devices: the ``sites`` axis of the mesh
(``mesh.py``) and its product-path dry run (``dryrun.py``)."""
