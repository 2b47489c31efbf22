"""Distribution utilities of the port: the elastic engine fleet
(``elastic.py``, a copy of the reference's), the serving mesh's config
check and the single-device restore (``sharding.py``). The reference's
``constrain.py`` belongs with tensor parallelism, which the port does not
have yet."""
