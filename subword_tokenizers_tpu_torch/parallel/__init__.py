"""The data-parallel layer of the port: a 1-D data mesh (``mesh``),
sharded training (``train``), sharded FastWP encode (``encode``) and
several processes running one program (``distributed``)."""
