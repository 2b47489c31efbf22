"""Distribution utilities of the port: the elastic engine fleet
(``elastic.py``, a copy of the reference's), ``sharding.py`` (the training
rules of the dry-run and the elastic restore, and the serving rules of the
tensor-parallel megastep; the meshes are ``launch/mesh.py``) and
``constrain.py``."""
from repro_torch.distributed.constrain import maybe_constrain

__all__ = ["maybe_constrain"]
