"""Distribution utilities of the port: the elastic engine fleet
(``elastic.py``, a copy of the reference's) and ``sharding.py``: the
serving rules of the tensor-parallel megastep (its mesh is
``launch/mesh.py``) and the single-device restore. The reference's
training rules, ``constrain.py`` and the dry-run belong to a later slice
of the port."""
